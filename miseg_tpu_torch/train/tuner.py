"""Batch-size autoscaling, the batch half of the reference's `trainer.tune`
(counterpart of `miseg_tpu/train/tuner.py`).

"Power" mode, as PyTorch Lightning's `Tuner.scale_batch_size`: one real
train step a candidate batch size, doubling from the start value until a
step runs out of memory, then the last size that fit.  Each trial runs
on a fresh `Trainer` over ROI-shaped random data, and the card's memory
is handed back between trials.  Only an out-of-memory error stops the
doubling (`is_oom_error`): any other error re-raises, so a shape bug
does not pass for a back-off.
"""

from __future__ import annotations

import gc
import tempfile
from typing import Callable

import numpy as np
import torch

# the JAX package's markers (XLA's resource-exhausted family), and
# PyTorch's "CUDA out of memory"
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted", "out of memory",
                "Out of memory", "OOM", "Allocation failure", "exceeds the memory")


def is_oom_error(e: BaseException) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in _OOM_MARKERS)


def _try_batch(cfg, batch_size: int, device=None) -> None:
    """One train step at `batch_size` on a fresh Trainer; raises on failure.
    Nothing of the trial outlives the call but its exception."""
    from .engine import Trainer

    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(cfg.replace(batch_size=batch_size), device=device,
                          workdir=workdir)
        rng = np.random.default_rng(0)
        batch = {"image": rng.random((batch_size, *cfg.roi, cfg.in_channels), np.float32),
                 "label": np.zeros((batch_size, *cfg.roi), np.int32),
                 "modality": (np.arange(batch_size) % max(1, cfg.num_styles)).astype(np.int32)}
        state = trainer.init_state()
        _, loss = trainer.train_step(state, batch)
        float(loss)   # waits for the card: an out-of-memory error surfaces here


def _free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def scale_batch_size(cfg, *, max_trials: int = 8, init_val: int | None = None,
                     step_fn: Callable[[object, int], None] | None = None,
                     verbose: bool = True, device=None) -> int:
    """The largest power-of-two multiple of `init_val` (default
    `cfg.batch_size`) whose train step fits in memory, trying at most
    `max_trials` sizes; `step_fn(cfg, batch_size)` runs one trial (by
    default a real step on `device`, the CUDA card unless given)."""
    def default_step(c, bs):
        _try_batch(c, bs, device)

    run = step_fn or default_step
    bs = int(init_val or cfg.batch_size or 1)
    best: int | None = None
    for _ in range(max_trials):
        try:
            run(cfg, bs)
            fits = True
        except Exception as e:  # noqa: BLE001 -- every other kind re-raises
            if not is_oom_error(e):
                raise
            fits = False
        _free_memory()   # after the handler: its traceback held the trial's tensors
        if not fits:
            if verbose:
                print(f"batch_size={bs} OOM — backing off")
            break
        best = bs
        if verbose:
            print(f"batch_size={bs} fits")
        bs *= 2
    if best is None:
        raise RuntimeError(
            f"batch_size={init_val or cfg.batch_size} does not fit in "
            "memory; reduce the ROI or the model size")
    return best
