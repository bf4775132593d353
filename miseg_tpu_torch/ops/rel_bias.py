"""Relative-position-bias lookup (forward only), counterpart of
`miseg_tpu/ops/rel_bias.py:35-78`."""

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


def rel_bias_gather(table_t: torch.Tensor, window_size: tuple[int, ...],
                    index: torch.Tensor | None = None) -> torch.Tensor:
    """`[H, T]` table -> `[H, N, N]` full-window bias, N = prod(window).
    `index` is the flat `rel_pos_index` on the table's device, when the
    caller keeps one there."""
    n = int(np.prod(window_size))
    if index is None:
        index = torch.tensor(_flat_index(tuple(window_size)), device=table_t.device)
    return table_t[:, index].reshape(-1, n, n)
