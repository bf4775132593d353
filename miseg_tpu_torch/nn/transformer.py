"""ViT-style transformer blocks: MLP, self-attention and the pre-norm block
(counterpart of `miseg_tpu/nn/transformer.py:29-89`).

The ViT's attention has no TPU kernel in the JAX package (an einsum
there), so it is plain PyTorch here and follows the same math: the QKᵀ
scores in f32 (f32 products of the operands, f32 sums) times
`head_dim ** -0.5`, the softmax in f32, dropout on the probabilities P,
P rounded to V's dtype, then P·V.  A fused library attention would keep
neither that rounding nor the port's seeded dropout.  The pre-norm
residual block's norms take `modalities`: an `instance_cond` norm of the
`[B, L, C]` tokens runs K1 + K2 with the L tokens as the spatial axis.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.nn.utils import skip_init

from .dropout import Dropout
from .factories import get_act
from .layers import Linear
from .norms import make_norm

NormSpec = tuple[str, dict[str, Any]] | str


class MLPBlock(nn.Module):
    """linear1 -> act -> dropout -> linear2 -> dropout."""

    def __init__(self, hidden: int, mlp_dim: int, act="gelu", dropout_rate: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        # skip_init: weights come from init_weights / a state dict
        self.linear1 = skip_init(Linear, hidden, mlp_dim, device=device, dtype=dtype)
        self.linear2 = skip_init(Linear, mlp_dim, hidden, device=device, dtype=dtype)
        self.act = get_act(act)
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        # under tensor parallelism h holds the rank's columns of the hidden
        # activation, and its dropout mask those columns of the whole one
        h = self.act(self.linear1(x))
        return self.drop(self.linear2(self.drop(h, columns=self.linear1.column_piece(h))))


class SABlock(nn.Module):
    """Multi-head self-attention over `[B, L, C]`: qkv -> attention -> proj
    -> dropout."""

    def __init__(self, hidden: int, num_heads: int, dropout_rate: float = 0.0,
                 qkv_bias: bool = False, *, device=None, dtype=None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError("hidden size must be divisible by num_heads")
        self.num_heads = num_heads
        self.qkv = skip_init(Linear, hidden, 3 * hidden, bias=qkv_bias, device=device,
                             dtype=dtype)
        self.proj = skip_init(Linear, hidden, hidden, device=device, dtype=dtype)
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        b, l, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, l, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        p = self.drop(scores.softmax(dim=-1))
        out = torch.matmul(p.to(v.dtype), v)                 # [B, H, L, hd]
        return self.drop(self.proj(out.transpose(1, 2).reshape(b, l, c)))


class TransformerBlock(nn.Module):
    """x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, hidden: int, mlp_dim: int, num_heads: int,
                 dropout_rate: float = 0.0, qkv_bias: bool = False,
                 norm: NormSpec = ("layer", {}), *, device=None, dtype=None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        dd = dict(device=device, dtype=dtype)
        self.norm1 = make_norm(norm, hidden, **dd)
        self.attn = SABlock(hidden, num_heads, dropout_rate, qkv_bias, **dd)
        self.norm2 = make_norm(norm, hidden, **dd)
        self.mlp = MLPBlock(hidden, mlp_dim, dropout_rate=dropout_rate, **dd)

    def forward(self, x, modalities=None):
        x = x + self.attn(self.norm1(x, modalities))
        return x + self.mlp(self.norm2(x, modalities))
