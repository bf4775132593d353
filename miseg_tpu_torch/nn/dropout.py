"""Dropout and per-sample drop-path (stochastic depth) drawn from an
explicit generator (counterpart of flax's `nn.Dropout` and
`miseg_tpu/nn/swin.py:52-62` `DropPath`).

Both act only in training mode and at a rate above 0; otherwise they
return their input and launch nothing.  In training they draw from the
generator installed by `rng(generator)` around the forward (the
`Trainer` installs its own, seeded every step from `(seed + 1, step)`)
and raise without one: the port never draws from the global RNG.  A kept
element is scaled by 1 / (1 - rate), as flax does.

Activation recompute (`nn/recompute.py`) runs a block's forward again in
the backward, after the `rng` block has closed; `torch.utils.checkpoint`
restores only the global RNGs.  So the recompute takes `snapshot()` at
the block's entry (the installed generator and its state) and draws
under `replay(snapshot)` from a fresh generator in that state: the masks
of the first forward, as flax's `nn.remat` replays them.

Under data parallelism (`parallel`) each rank draws the mask of the
global batch, `world` times its own leading extent, and keeps its slice
(`rank`-th of `world`): the mask JAX draws over its global array, so
two ranks drop what one process drops over their concatenated batch.
Every mask's leading axis is batch-major (`[B, ...]`, `[B * nW, ...]`).
The rank and world are the "data" coordinate and size
(`parallel.host_shard_info`): the ranks of one line of the other axes
share a batch and draw the same masks.  Under tensor parallelism the
MLP's hidden activation holds the rank's piece of its columns
(`columns`); its mask is that piece of the whole activation's, so one
process and the ranks drop the same elements.  Under spatial
partitioning (`parallel/spatial.py`, `spatial.mask_part`) an element-wise
mask of a D slab is the rank's slab of the whole volume's mask, and one of
a swin block's window rows (attention and projection dropout) those rows
of the whole windows' mask (beside tensor parallelism, those of the
column piece's mask); drop-path masks are per sample, the same on every
rank of the line.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from .. import parallel
from ..parallel import spatial

_generator: contextvars.ContextVar[torch.Generator | None] = contextvars.ContextVar(
    "miseg_dropout_generator", default=None)


@contextlib.contextmanager
def rng(generator: torch.Generator):
    """Dropout and drop-path inside this block draw from `generator`."""
    token = _generator.set(generator)
    try:
        yield generator
    finally:
        _generator.reset(token)


def snapshot() -> tuple[torch.Generator, torch.Tensor] | None:
    """The installed generator and its state now, or None without one."""
    gen = _generator.get()
    return None if gen is None else (gen, gen.get_state())


@contextlib.contextmanager
def replay(snap: tuple[torch.Generator, torch.Tensor] | None):
    """Dropout inside this block draws what it drew after `snap` was taken,
    from a fresh generator in that state (the installed one is left as it
    is).  Without a snapshot the block drew nothing, and nothing changes."""
    if snap is None:
        yield
        return
    gen, state = snap
    fresh = torch.Generator(device=gen.device)
    fresh.set_state(state)
    with rng(fresh):
        yield


def _drop(x: torch.Tensor, rate: float, mask_shape,
          columns: tuple[int, int] | None = None) -> torch.Tensor:
    gen = _generator.get()
    if gen is None:
        raise RuntimeError("dropout in training mode needs a generator: run the "
                           "forward inside `miseg_tpu_torch.nn.dropout.rng(generator)`")
    if rate >= 1.0:
        return torch.zeros_like(x)
    rank, world = parallel.host_shard_info()
    mask_shape, take = spatial.mask_part(x, tuple(mask_shape))
    n = mask_shape[0]
    if columns is None:
        draw = torch.rand((world * n, *mask_shape[1:]), generator=gen, device=x.device)
    else:
        piece, pieces = columns
        k = mask_shape[-1]
        draw = torch.rand((world * n, *mask_shape[1:-1], pieces * k), generator=gen,
                          device=x.device)[..., piece * k:(piece + 1) * k]
    draw = draw[rank * n:(rank + 1) * n]
    keep = (draw if take is None else take(draw)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Element-wise dropout at `rate`."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, columns: tuple[int, int] | None = None):
        """`columns` (piece, pieces): `x` holds that piece of the last dim
        of the activation whose mask is drawn."""
        if not self.training or self.rate == 0.0:
            return x
        return _drop(x, self.rate, x.shape, columns)


class DropPath(nn.Module):
    """Drops a residual branch whole, per sample (one draw a leading index)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return _drop(x, self.rate, (x.shape[0],) + (1,) * (x.ndim - 1))
