"""Relative-position-bias lookup with a separable, scatter-free backward
(counterpart of `miseg_tpu/ops/rel_bias.py:35-99`).

The rel-pos index is separable, `index(p, q) = sum_i stride_i (p_i - q_i +
w_i - 1)`, so the table's cotangent factors into one small one-hot
contraction per spatial dim, `E_i[a, p, q] = [p - q + w_i - 1 == a]`
(`[2w_i - 1, w_i, w_i]`), as JAX's `_gather_bwd` does.  Indexing autograd
would scatter-add N^2 entries instead, with atomics on the card, whose sums
come out in another order from run to run; the contraction is the same on
every run.  A clipped window's `[:n, :n]` prefix (nn/swin.py) is sliced
after the gather, so its cotangent arrives zero-padded to the full window
and goes through the same contraction.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def rel_pos_index(window_size: Sequence[int]) -> np.ndarray:
    """Static `[N, N]` index into the `(2w-1)^nd`-entry bias table,
    row-major over the window grid (reference window_attention.py:60-77)."""
    grids = np.meshgrid(*[np.arange(w) for w in window_size], indexing="ij")
    coords = np.stack([g.reshape(-1) for g in grids])  # [nd, N]
    rel = coords[:, :, None] - coords[:, None, :]      # [nd, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    strides = []
    acc = 1
    for w in reversed(window_size):
        strides.append(acc)
        acc *= 2 * w - 1
    strides = strides[::-1]
    for i, w in enumerate(window_size):
        rel[:, :, i] += w - 1
        rel[:, :, i] *= strides[i]
    return rel.sum(-1)


@functools.lru_cache(maxsize=16)
def _flat_index(window_size: tuple[int, ...]) -> np.ndarray:
    idx = rel_pos_index(window_size).reshape(-1)
    idx.setflags(write=False)  # cached: shared by every caller
    return idx


@functools.lru_cache(maxsize=16)
def _dim_onehot(w: int) -> np.ndarray:
    """E[a, p, q] = [p - q + w - 1 == a], `[2w-1, w, w]` f32 (numpy: the
    cache holds no device tensors)."""
    p = np.arange(w)
    rel = p[:, None] - p[None, :] + w - 1
    e = (np.arange(2 * w - 1)[:, None, None] == rel[None]).astype(np.float32)
    e.setflags(write=False)
    return e


def rel_bias_gather_bwd(grad: torch.Tensor, window_size: tuple[int, ...]) -> torch.Tensor:
    """VJP of `rel_bias_gather` (`_gather_bwd` :80): `[H, N, N]` cotangent
    -> f32 `[H, T]` table cotangent, one contraction per spatial dim."""
    ws = tuple(window_size)
    nd = len(ws)
    out = grad.reshape(grad.shape[0], *ws, *ws).float()
    # axes [h, p_0..p_{nd-1}, q_0..q_{nd-1}]; each step contracts (p_i,
    # q_i) with E_i and appends the table axis a_i at the end
    for i in range(nd):
        e = torch.from_numpy(_dim_onehot(ws[i]).copy()).to(grad.device)
        # at step i, p_i sits at axis 1 and q_i at axis 1 + (nd - i)
        out = torch.tensordot(e, out, dims=([1, 2], [1, 1 + (nd - i)])).movedim(0, -1)
    # axes [h, a_0..a_{nd-1}], row-major as rel_pos_index's strides
    return out.reshape(grad.shape[0], -1)


def _gather(table_t, window_size, index):
    n = int(np.prod(window_size))
    return table_t[:, index].reshape(-1, n, n)


class _RelBiasGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_t, window_size, index):
        ctx.window_size, ctx.dtype = window_size, table_t.dtype
        return _gather(table_t, window_size, index)

    @staticmethod
    def backward(ctx, grad):
        return rel_bias_gather_bwd(grad, ctx.window_size).to(ctx.dtype), None, None


def rel_bias_gather(table_t: torch.Tensor, window_size: tuple[int, ...],
                    index: torch.Tensor | None = None) -> torch.Tensor:
    """`[H, T]` table -> `[H, N, N]` full-window bias, N = prod(window).
    `index` is the flat `rel_pos_index` on the table's device, when the
    caller keeps one there.  Differentiable in the table
    (`rel_bias_gather_bwd`)."""
    if index is None:
        index = torch.tensor(_flat_index(tuple(window_size)), device=table_t.device)
    if torch.is_grad_enabled():
        return _RelBiasGather.apply(table_t, tuple(window_size), index)
    return _gather(table_t, window_size, index)
