"""Integer arrival counters for kernels that finish a reduction inside one
launch (K1's `miseg_k1_stats` and `miseg_k1_fold`, K4's split-K coarse
path).

The CTAs of such a launch each write a partial result, then add one to a
counter; the last to arrive reads the others' partials and resets the
counter to 0.  So a call needs counters that are 0 when it starts, and
leaves them at 0.  One buffer serves every such kernel on a device and
stream: launches on one stream run one after another, and each uses the
buffer from index 0.  It is zeroed once, when it is made, and replaced by
a larger one only when a call needs more; no call launches a memset, so
a captured CUDA graph replays without one.
"""

from __future__ import annotations

import torch

_buffers: dict[tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor | None:
    """At least `n` int32 arrival counters for calls on this device and
    stream, all 0 between launches; None when the call needs none."""
    if n == 0:
        return None
    key = (device.index, stream)
    buf = _buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _buffers[key] = buf
    return buf
