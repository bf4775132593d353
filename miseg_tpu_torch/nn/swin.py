"""Swin transformer blocks, 2-D and 3-D (counterpart of
`miseg_tpu/nn/swin.py:65-280`): window attention, the shifted-window
block, patch merging (incl. the legacy slice order) and patch embedding.
The blocks take their rank from their input, patch merging and patch
embedding from `spatial_dims` and the patch size.

Window attention runs kernel K5 (`ops.kernels.window_attention`) on the
card; every norm runs K1 + K2.  Dropout (after the projection and in the
MLP), attention dropout (on the softmax probabilities) and per-sample
drop-path act only in training (`nn/dropout.py`).

Under spatial partitioning (`parallel/spatial.py`) a block on a D slab
normalises its slab (statistics merged over the line), gathers the whole
volume (`gather_d`), pads, rolls and partitions it as one process does,
and attends only its share of the window rows along D (qkv, K5 with those
rows' region ids and the bias, proj); the rows are gathered back
(`gather_rows`), reversed, rolled back and cropped, and the rank keeps
its slab (`slice_d`).  A rank with no rows launches no K5.  The MLP and
norm2 run on the slab.  Patch merging is local on an even slab (its
odd-size pad belongs to the whole volume only), then takes its level's
state (`spatial.settle`); patch embedding pads by the whole volume's
dims.
"""

from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.init import fill_, trunc_normal
from ..ops.kernels.window_attention import window_attention
from ..ops.rel_bias import rel_bias_gather, rel_pos_index
from ..ops.window import ATTN_MASK_VALUE, get_window_size, window_partition, window_reverse
from ..parallel import spatial
from .convolutions import Conv
from .dropout import Dropout, DropPath
from .layers import Linear
from .norms import make_norm
from .transformer import MLPBlock

NormSpec = tuple[str, dict[str, Any]] | str


def _pad_cl(x: torch.Tensor, hi: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the high side of the spatial dims of `[B, *spatial, C]`."""
    if not any(hi):
        return x
    pad = [0, 0]
    for h in reversed(hi):
        pad += [0, h]
    return F.pad(x, pad)


class WindowAttention(nn.Module):
    """Windowed MHSA with relative position bias over `[B*nW, N, C]`.

    The bias table is sized for the CONFIGURED window; a runtime-clipped
    window of n < prod(window) tokens uses the `[:n, :n]` prefix of the
    full bias (the reference's quirk, nn/swin.py:98-101)."""

    def __init__(self, dim: int, num_heads: int, window_size, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.window_size = tuple(window_size)
        table_len = math.prod(2 * w - 1 for w in self.window_size)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((table_len, num_heads), device=device, dtype=dtype))
        self.qkv = skip_init(Linear, dim, 3 * dim, bias=qkv_bias,
                             device=device, dtype=dtype)
        self.proj = skip_init(Linear, dim, dim, device=device, dtype=dtype)
        index = torch.from_numpy(rel_pos_index(self.window_size).reshape(-1))
        self.register_buffer("rel_index", index.to(device), persistent=False)

    def init_parameters(self, generator) -> None:
        fill_(self.relative_position_bias_table,
              trunc_normal(self.relative_position_bias_table.shape, 0.02, generator))

    def forward(self, x, mask=None):
        b, n, c = x.shape
        qkv = self.qkv(x)                                   # [b, n, 3c]
        bias = rel_bias_gather(self.relative_position_bias_table.t(),
                               self.window_size, self.rel_index)
        if n != bias.shape[-1]:
            bias = bias[:, :n, :n]
        bias = bias.float().contiguous()
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        if b == 0:
            # a rank with no window rows under spatial partitioning: no K5,
            # but its dropout still draws the whole windows' masks
            out = q
            if self.training and self.attn_drop.rate > 0:
                self.attn_drop(q.new_zeros((0, self.num_heads, n, n)))
        elif self.training and self.attn_drop.rate > 0:
            # The configuration chooses this route, as in the reference
            # (miseg_tpu/nn/swin.py:113): K5 applies no dropout to P, so
            # attention dropout in training runs the attention in PyTorch
            # ops.  Neither the device nor a failure ever chooses it.
            out = self._attend_dropped(q, k, v, bias, mask)
        else:
            out = window_attention(q, k, v, bias, mask, num_heads=self.num_heads)
        return self.proj_drop(self.proj(out))

    def _attend_dropped(self, q, k, v, bias, ids):
        """The JAX package's unfused attention (miseg_tpu/nn/swin.py:121-160):
        f32 scores, bias and region mask, f32 softmax, dropout on P, then
        P (in v's dtype) times v."""
        bw, n, c = q.shape
        h = self.num_heads
        hd = c // h
        s = torch.einsum("bnhd,bmhd->bhnm", q.reshape(bw, n, h, hd).float(),
                         k.reshape(bw, n, h, hd).float()) * hd ** -0.5
        s = s + bias[None]
        if ids is not None:
            nw = ids.shape[0]
            neq = ids[:, None, :] != ids[:, :, None]
            s = s.reshape(bw // nw, nw, h, n, n)
            s = torch.where(neq[None, :, None], s + ATTN_MASK_VALUE, s).reshape(bw, h, n, n)
        p = self.attn_drop(torch.softmax(s, dim=-1))
        return torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype),
                            v.reshape(bw, n, h, hd)).reshape(bw, n, c)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size, shift_size,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 act="gelu", norm: NormSpec = ("layer", {}), *, device=None,
                 dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.norm1 = make_norm(norm, dim, **dd)
        self.attn = WindowAttention(dim, num_heads, self.window_size,
                                    qkv_bias, attn_drop, drop, **dd)
        self.norm2 = make_norm(norm, dim, **dd)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), act, drop, **dd)
        self.drop_path = DropPath(drop_path)

    def _pad_roll_attend(self, x, mask, modalities):
        x = self.norm1(x, modalities)
        line = spatial.line_of(x)
        if line is not None:
            x = spatial.gather_d(x, line)
        b, *dims, _ = x.shape
        window_size, shift_size = get_window_size(dims, self.window_size,
                                                  self.shift_size)
        x = _pad_cl(x, tuple((w - s % w) % w for s, w in zip(dims, window_size)))
        padded = x.shape[1:-1]
        axes = tuple(range(1, 1 + len(dims)))
        shifted = any(shift_size)
        if shifted:
            x = torch.roll(x, [-s for s in shift_size], dims=axes)
        windows = window_partition(x, window_size)
        mask = mask if shifted else None
        if line is None:
            attn = self.attn(windows, mask)
        else:
            attn = self._attend_rows(windows, mask, b, padded[0] // window_size[0], line)
        x = window_reverse(attn, window_size, (b, *padded))
        if shifted:
            x = torch.roll(x, list(shift_size), dims=axes)
        x = x[(slice(None), *(slice(0, n) for n in dims))]
        return x if line is None else spatial.slice_d(x, line)

    def _attend_rows(self, windows, ids, b, n_rows, line):
        """Attention on this rank's share of the `n_rows` window rows
        along D of every sample (with those rows' region ids), the rows of
        every rank gathered back: `windows`' layout."""
        _, n, c = windows.shape
        per = windows.shape[0] // (b * n_rows)
        first, end, counts = spatial.window_rows(n_rows, line)
        mine = windows.reshape(b, n_rows, per, n, c)[:, first:end].reshape(-1, n, c)
        if ids is not None:
            ids = ids.reshape(n_rows, per, n)[first:end].reshape(-1, n)
        with spatial.rows(b, n_rows, per, first, end):
            out = self.attn(mine, ids)
        out = spatial.gather_rows(out.reshape(b, end - first, per, n, c), counts, line)
        return out.reshape(-1, n, c)

    def forward(self, x, mask=None, modalities=None):
        x = x + self.drop_path(self._pad_roll_attend(x, mask, modalities))
        return x + self.drop_path(self.mlp(self.norm2(x, modalities)))


# MONAI v0.9 slice order, duplicated slices included (nn/swin.py:240-243)
_LEGACY_OFFSETS = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                   (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1)]
# 2-D, both variants: the reference iterates product() as (i, j) but
# slices [j::2, i::2] (nn/swin.py:248-252), so the offsets are (j, i)
_OFFSETS_2D = [(j, i) for i, j in itertools.product((0, 1), repeat=2)]


class PatchMergingV2(nn.Module):
    """2^nd space-to-channel concat -> norm -> Linear(2^nd*dim -> 2*dim,
    no bias)."""

    def __init__(self, dim: int, norm: NormSpec = ("instance_cond", {}),
                 legacy: bool = False, *, spatial_dims: int = 3, device=None,
                 dtype=None):
        super().__init__()
        if spatial_dims == 2:
            self.offsets = _OFFSETS_2D
        else:
            self.offsets = (_LEGACY_OFFSETS if legacy
                            else list(itertools.product((0, 1), repeat=3)))
        merged = 2 ** spatial_dims * dim
        self.norm = make_norm(norm, merged, device=device, dtype=dtype)
        self.reduction = skip_init(Linear, merged, 2 * dim, bias=False,
                                   device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        slab = spatial.line_of(x) is not None
        x = _pad_cl(x, tuple(s % 2 for s in x.shape[1:-1]))
        x = torch.cat([x[(slice(None), *(slice(o, None, 2) for o in off))]
                       for off in self.offsets], dim=-1)
        return self.reduction(self.norm(spatial.settle(x, slab), modalities))


class PatchEmbed(nn.Module):
    """Pad to the patch multiple, then a strided conv (+ optional norm)."""

    def __init__(self, patch_size, in_chans: int, embed_dim: int = 48,
                 norm: NormSpec | None = None, *, device=None, dtype=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = Conv(in_chans, embed_dim, self.patch_size, self.patch_size,
                         0, True, spatial_dims=len(self.patch_size), device=device,
                         dtype=dtype)
        self.norm = make_norm(norm, embed_dim, device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        x = _pad_cl(x, tuple((p - s % p) % p
                             for s, p in zip(spatial.global_dims(x), self.patch_size)))
        x = self.proj(x)
        return x if self.norm is None else self.norm(x, modalities)
