"""ViT patch embedding (counterpart of
`miseg_tpu/nn/patch_embedding.py:20-110`): a strided conv ("conv") or a
space-to-patch rearrange and a Linear ("perceptron") patchifies the
channel-last volume into `[B, n_patches, hidden]` tokens, then a position
embedding is added: a learned `[1, n_patches, hidden]` table, the fixed
sine-cosine table (a buffer, not a parameter: it is frozen), or none.
The perceptron's patch vector flattens in the JAX package's
`(p0, p1, p2, C)` order, so its bridged Linear sees the same inputs.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.init import fill_, trunc_normal
from .convolutions import Conv
from .dropout import Dropout


def build_sincos_position_embedding(grid_size: Sequence[int], embed_dim: int,
                                    temperature: float = 10000.0) -> np.ndarray:
    """MONAI's per-axis sine-cosine table, `[1, prod(grid), embed_dim]` f32:
    `embed_dim // (2 * ndim)` frequencies, concatenated as [sin(axis 0),
    cos(axis 0), sin(axis 1), ...] along the channels (the JAX package's
    copy, patch_embedding.py:20-43)."""
    nd = len(grid_size)
    if embed_dim % (2 * nd):
        raise ValueError(
            f"embed_dim must be divisible by {2 * nd} for {nd}D sincos "
            f"position embedding, got {embed_dim}")
    pos_dim = embed_dim // (2 * nd)
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    grids = np.meshgrid(*[np.arange(g, dtype=np.float32) for g in grid_size],
                        indexing="ij")
    parts = []
    for g in grids:
        out = g.reshape(-1)[:, None] * omega[None]
        parts += [np.sin(out), np.cos(out)]
    return np.concatenate(parts, axis=1)[None].astype(np.float32)


class _PerceptronLinear(nn.Linear):
    """The perceptron's Linear: a truncated-normal(0.02) kernel, zero bias."""

    def init_parameters(self, generator) -> None:
        fill_(self.weight, trunc_normal(self.weight.shape, 0.02, generator))
        fill_(self.bias, torch.zeros(self.bias.shape))


class PatchEmbeddingBlock(nn.Module):
    def __init__(self, in_channels: int, img_size: Sequence[int],
                 patch_size: Sequence[int], hidden_size: int, num_heads: int,
                 pos_embed: str = "conv", pos_embed_type: str = "learnable",
                 dropout_rate: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads:
            raise ValueError("hidden size should be divisible by num_heads.")
        for m, p in zip(img_size, patch_size):
            if m < p:
                raise ValueError("patch_size should be smaller than img_size.")
            if pos_embed == "perceptron" and m % p:
                raise ValueError("img_size should be divisible by patch_size for perceptron.")
        self.patch_size = tuple(patch_size)
        self.hidden_size = hidden_size
        self.pos_embed = pos_embed
        grid = [m // p for m, p in zip(img_size, patch_size)]
        n_patches = math.prod(grid)
        dd = dict(device=device, dtype=dtype)
        if pos_embed == "conv":
            self.patch_embeddings = Conv(in_channels, hidden_size, self.patch_size,
                                         self.patch_size, 0, bias=True, **dd)
        elif pos_embed == "perceptron":
            self.patch_embeddings = _PerceptronLinear(
                math.prod(self.patch_size) * in_channels, hidden_size, **dd)
        else:
            raise ValueError(f"unsupported pos_embed {pos_embed!r}")
        self.position_embeddings = None
        self.register_buffer("sincos", None, persistent=False)
        if pos_embed_type == "sincos":
            table = torch.from_numpy(build_sincos_position_embedding(grid, hidden_size))
            self.sincos = table.to(device)
        elif pos_embed_type == "learnable":
            self.position_embeddings = nn.Parameter(
                torch.empty((1, n_patches, hidden_size), **dd))
        elif pos_embed_type != "none":
            raise ValueError(f"unsupported pos_embed_type {pos_embed_type!r}")
        self.drop = Dropout(dropout_rate)

    def init_parameters(self, generator) -> None:
        if self.position_embeddings is not None:
            fill_(self.position_embeddings,
                  trunc_normal(self.position_embeddings.shape, 0.02, generator))

    def forward(self, x):
        """`x [B, *spatial, C]` -> tokens `[B, n_patches, hidden]`."""
        b = x.shape[0]
        if self.pos_embed == "conv":
            x = self.patch_embeddings(x).reshape(b, -1, self.hidden_size)
        else:
            # [B, (g0 p0), (g1 p1), (g2 p2), C] -> [B, g0 g1 g2, p0 p1 p2 C]
            grid = [s // p for s, p in zip(x.shape[1:-1], self.patch_size)]
            shape = [b]
            for g, p in zip(grid, self.patch_size):
                shape += [g, p]
            nd = len(grid)
            perm = ([0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)]
                    + [2 * nd + 1])
            x = x.reshape(*shape, x.shape[-1]).permute(perm).reshape(b, math.prod(grid), -1)
            x = self.patch_embeddings(x)
        pos = self.position_embeddings if self.position_embeddings is not None else self.sincos
        if pos is not None:
            x = x + pos.to(x.dtype)
        return self.drop(x)
