"""Shifted-window utilities for 3-D Swin attention (channel-last),
counterpart of `miseg_tpu/ops/window.py`.

The shifted-window mask travels as region ids `int32 [nW, N]`: two tokens
attend without penalty iff their ids match, and a differing pair gets the
ADDITIVE `ATTN_MASK_VALUE` (-100, not -inf), as the reference's
masked_fill does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ATTN_MASK_VALUE = -100.0


def get_window_size(x_size, window_size, shift_size=None):
    """Per dim: if the input dim <= window, clamp the window to it and zero
    the shift."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            if use_shift is not None:
                use_shift[i] = 0
    if shift_size is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """`[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]` (a contiguous copy)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window_size, dims) -> torch.Tensor:
    """Inverse of `window_partition`; `dims` is `(B, D, H, W)`."""
    b, d, h, w = dims
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


def _region_ids_1d(dim: int, ws: int, ss: int) -> np.ndarray:
    if ss == 0:
        return np.zeros((dim,), np.int32)
    pos = np.arange(dim)
    return ((pos >= dim - ws).astype(np.int32)
            + (pos >= dim - ss).astype(np.int32))


@functools.lru_cache(maxsize=64)
def _region_ids_np(dims: tuple, window_size: tuple,
                   shift_size: tuple) -> np.ndarray | None:
    if not any(shift_size):
        return None
    region = np.zeros(dims, np.int32)
    for i, (d, w, s) in enumerate(zip(dims, window_size, shift_size)):
        shape = [1] * len(dims)
        shape[i] = -1
        region = region * 3 + _region_ids_1d(d, w, s).reshape(shape)
    # `window_partition` in numpy (no torch op: this runs while tracing too)
    (d, h, w), (wd, wh, ww) = dims, window_size
    ids = np.ascontiguousarray(region.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
                               .transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww))
    ids.setflags(write=False)  # cached: shared by every caller
    return ids


def window_region_ids(dims, window_size, shift_size,
                      device: torch.device | str = "cpu") -> torch.Tensor | None:
    """Per-window region ids `int32 [nW, N]` for the shifted-window mask
    over padded `dims` (ops/window.py:118-147), or None when unshifted."""
    ids = _region_ids_np(tuple(dims), tuple(window_size), tuple(shift_size))
    return None if ids is None else torch.tensor(ids, device=device)
