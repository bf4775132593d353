"""Shifted-window utilities for 2-D and 3-D Swin attention
(channel-last), counterpart of `miseg_tpu/ops/window.py`.

The shifted-window mask travels as region ids `int32 [nW, N]`: two tokens
attend without penalty iff their ids match, and a differing pair gets the
ADDITIVE `ATTN_MASK_VALUE` (-100, not -inf), as the reference's
masked_fill does.
"""

from __future__ import annotations

import functools
import math

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


def _partition_order(nd: int) -> tuple[int, ...]:
    """`[B, n_0, w_0, ..., n_{nd-1}, w_{nd-1}, C]` -> `[B, n_0.., w_0.., C]`."""
    return (0, *range(1, 2 * nd, 2), *range(2, 2 * nd + 1, 2), 2 * nd + 1)


def _blocked(dims, window_size) -> list[int]:
    out = []
    for d, w in zip(dims, window_size):
        out += [d // w, w]
    return out


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """`[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]`, or `[B, H, W, C] ->
    [B*nW, wh*ww, C]` (a contiguous copy)."""
    b, *spatial, c = x.shape
    x = x.reshape(b, *_blocked(spatial, window_size), c)
    x = x.permute(_partition_order(len(spatial)))
    return x.reshape(-1, math.prod(window_size), c)


def window_reverse(windows: torch.Tensor, window_size, dims) -> torch.Tensor:
    """Inverse of `window_partition`; `dims` is `(B, D, H, W)` or `(B, H, W)`."""
    b, *spatial = dims
    nd = len(spatial)
    x = windows.reshape(b, *(s // w for s, w in zip(spatial, window_size)),
                        *window_size, -1)
    # [B, n_0.., w_0.., C] -> [B, n_0, w_0, ..., C]
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    x = x.permute(*perm, 2 * nd + 1)
    return x.reshape(b, *spatial, -1)


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
    nd = len(dims)
    ids = np.ascontiguousarray(
        region.reshape(_blocked(dims, window_size))
        .transpose(*range(0, 2 * nd, 2), *range(1, 2 * nd, 2))
        .reshape(-1, math.prod(window_size)))
    ids.setflags(write=False)  # cached: shared by every caller
    return ids


def window_region_ids(dims, window_size, shift_size,
                      device: torch.device | str = "cpu") -> torch.Tensor | None:
    """Per-window region ids `int32 [nW, N]` for the shifted-window mask
    over padded `dims` (ops/window.py:118-147), or None when unshifted."""
    ids = _region_ids_np(tuple(dims), tuple(window_size), tuple(shift_size))
    return None if ids is None else torch.tensor(ids, device=device)
