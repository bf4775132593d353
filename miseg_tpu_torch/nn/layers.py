"""Gradient reversal (counterpart of `miseg_tpu/nn/layers.py:41-62`): the
identity forward, the gradient scaled by `-alpha` on the way back (the
ViT classification head's adversarial hook)."""

from __future__ import annotations

import torch
from torch import nn


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha: float):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def gradient_reversal(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Identity forward; gradient scaled by -alpha on the way back."""
    return _GradientReversal.apply(x, alpha)


class GradientReversal(nn.Module):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        return gradient_reversal(x, self.alpha)
