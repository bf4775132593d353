"""Swin Transformer backbone, 2-D or 3-D by the window's rank (counterpart of
`miseg_tpu/models/swin_transformer.py:39-140`).

Patch embed (stride = patch size) -> 4 stages of `depth` blocks with
alternating shift, each followed by patch merging; `proj_out`
re-normalizes every pyramid level with a PARAMETER-FREE norm.  For the
instance kinds that norm runs through K1 + K2, the same function the JAX
package computes in plain jnp (on a D slab under spatial partitioning,
with the whole volume's statistics, `parallel/spatial.py`).  The region
ids of the shifted windows come from the whole volume's padded shape.
In training, dropout follows the patch embedding and the blocks'
drop-path rates rise linearly from 0 to `drop_path_rate` over all blocks
(`np.linspace`, as the JAX package).
With `use_checkpoint` each swin block is recomputed in the backward
(`nn/recompute.py`), as the JAX package remats it.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..nn import recompute
from ..nn.dropout import Dropout
from ..nn.swin import PatchEmbed, PatchMergingV2, SwinTransformerBlock
from ..ops.norms import layer_norm
from ..ops.window import get_window_size, window_region_ids
from ..parallel import spatial
from ..parallel.spatial import instance_norm_act

NormSpec = tuple[str, dict[str, Any]] | str


def _kind(norm: NormSpec) -> str:
    return norm if isinstance(norm, str) else norm[0]


class BasicLayer(nn.Module):
    """One swin stage: blocks with alternating shift + optional downsample."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Sequence[int], drop_path: Sequence[float] = (),
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0, downsample: str | None = None,
                 norm: NormSpec = ("layer", {}), use_checkpoint: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        shift = tuple(w // 2 for w in self.window_size)
        no_shift = (0,) * len(self.window_size)
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinTransformerBlock(
                dim, num_heads, self.window_size,
                no_shift if i % 2 == 0 else shift, mlp_ratio, qkv_bias, drop, attn_drop,
                drop_path[i] if i < len(drop_path) else 0.0,
                norm=norm, device=device, dtype=dtype))
        self.downsample = (PatchMergingV2(dim, norm, legacy=downsample == "merging",
                                          spatial_dims=len(self.window_size),
                                          device=device, dtype=dtype)
                           if downsample is not None else None)
        self._ids: dict = {}  # region ids per (padded dims, device)

    def _region_ids(self, padded, window_size, shift_size, device):
        if torch.compiler.is_compiling():   # a traced constant: not cached for eager calls
            return window_region_ids(padded, window_size, shift_size, device=device)
        key = (padded, window_size, shift_size, str(device))
        if key not in self._ids:
            self._ids[key] = window_region_ids(padded, window_size, shift_size,
                                               device=device)
        return self._ids[key]

    def forward(self, x, modalities=None):
        dims = spatial.global_dims(x)   # the whole volume's, on a D slab
        window_size, shift_size = get_window_size(
            dims, self.window_size, tuple(w // 2 for w in self.window_size))
        padded = tuple(int(math.ceil(s / w)) * w for s, w in zip(dims, window_size))
        ids = self._region_ids(padded, window_size, shift_size, x.device)
        for i in range(self.depth):
            blk = getattr(self, f"blocks_{i}")
            x = recompute.call(blk, x, ids if i % 2 else None, modalities,
                               recompute=self.use_checkpoint)
        if self.downsample is not None:
            x = self.downsample(x, modalities)
        return x


class SwinTransformer(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, window_size: Sequence[int],
                 patch_size: Sequence[int], depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 patch_norm: bool = False, downsample: str = "merging",
                 norm: NormSpec = ("layer", {}), use_checkpoint: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.norm_kind = _kind(norm)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      norm if patch_norm else None,
                                      device=device, dtype=dtype)
        self.pos_drop = Dropout(drop_rate)
        self.num_layers = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        for i in range(self.num_layers):
            self.add_module(f"layers{i + 1}", BasicLayer(
                int(embed_dim * 2 ** i), depths[i], num_heads[i], window_size,
                dpr[sum(depths[:i]):sum(depths[:i + 1])], mlp_ratio, qkv_bias,
                drop_rate, attn_drop_rate, downsample, norm, use_checkpoint, device=device,
                dtype=dtype))

    def _proj_out(self, x, normalize: bool):
        """Parameter-free per-stage re-normalization."""
        if not normalize:
            return x
        if self.norm_kind == "layer":
            return layer_norm(x)
        if self.norm_kind in ("instance", "instance_cond"):
            return instance_norm_act(x)
        return x

    def forward(self, x, normalize: bool = True, modalities=None):
        x0 = self.pos_drop(self.patch_embed(x, modalities))
        outs = [self._proj_out(x0, normalize)]
        h = x0
        for i in range(self.num_layers):
            h = getattr(self, f"layers{i + 1}")(h, modalities)
            outs.append(self._proj_out(h, normalize))
        return outs
