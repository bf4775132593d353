"""Transformer MLP block (counterpart of `miseg_tpu/nn/transformer.py:29-41`)."""

from __future__ import annotations

from torch import nn
from torch.nn.utils import skip_init

from .dropout import Dropout
from .factories import get_act


class MLPBlock(nn.Module):
    """linear1 -> act -> dropout -> linear2 -> dropout."""

    def __init__(self, hidden: int, mlp_dim: int, act="gelu", dropout_rate: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        # skip_init: weights come from init_weights / a state dict
        self.linear1 = skip_init(nn.Linear, hidden, mlp_dim, device=device, dtype=dtype)
        self.linear2 = skip_init(nn.Linear, mlp_dim, hidden, device=device, dtype=dtype)
        self.act = get_act(act)
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        return self.drop(self.linear2(self.drop(self.act(self.linear1(x)))))
