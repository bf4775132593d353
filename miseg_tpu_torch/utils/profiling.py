"""Profiling hooks (counterpart of `miseg_tpu/utils/profiling.py`):
`profile_trace` records a region with torch.profiler and writes a Chrome
trace (`trace.json`, readable in Perfetto or chrome://tracing) to a
directory; `StepTimer` gives steps per second of host wall time, waiting
for the device when handed a tensor.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the enclosed region into `<log_dir>/trace.json` (CPU, and CUDA
    when a card is present); a no-op when `log_dir` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StepTimer:
    """Wall-clock steps per second, leaving out the first `skip_first`
    (warm-up) steps."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.reset()

    def reset(self):
        self._count = 0
        self._elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result: torch.Tensor | None = None) -> float:
        """Seconds since `start`, after the device has finished `result`
        (a CUDA tensor) when given."""
        if result is not None and result.is_cuda:
            torch.cuda.synchronize(result.device)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self._elapsed += dt
        return dt

    @property
    def steps_per_sec(self) -> float:
        n = max(0, self._count - self.skip_first)
        return n / self._elapsed if self._elapsed > 0 else 0.0
