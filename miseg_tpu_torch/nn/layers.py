"""Gradient reversal (counterpart of `miseg_tpu/nn/layers.py:41-62`): the
identity forward, the gradient scaled by `-alpha` on the way back (the
ViT classification head's adversarial hook); and the Linear of the
transformer matmuls, which runs Megatron's column- or row-parallel form
when tensor parallelism hands it a shard of its weight
(`parallel/tensor.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor as tp


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


class Linear(nn.Linear):
    """`nn.Linear`, whose `tp` (set by `parallel.tensor.attach`: role,
    piece, pieces, the axis' line) makes it a Megatron layer whenever the
    weight it runs with is a shard (the training forward under tensor
    parallelism); with its whole weight (evaluation, one process) it is
    the plain layer.
      * "col": the output's columns of this piece; the input's gradient
        summed over the line (f);
      * "row": the input's columns of this piece (taken here from a
        replicated input; a column layer's output already is), the
        partial products summed over the line (g), then the bias."""

    tp: tuple | None = None

    def forward(self, x):
        w = self.weight
        if self.tp is None or w.shape == (self.out_features, self.in_features):
            return F.linear(x, w, self.bias)
        role, index, size, group = self.tp
        if role == "col":
            return F.linear(tp.copy_to(x, group), w, self.bias)
        if x.shape[-1] == self.in_features:
            x = tp.slice_columns(x, index, size, group)
        y = tp.reduce_from(F.linear(x, w), group)
        return y if self.bias is None else y + self.bias

    def column_piece(self, y: torch.Tensor) -> tuple[int, int] | None:
        """(piece, pieces) when `y`, this column layer's output, holds only
        this piece of its columns; else None."""
        if self.tp is None or self.tp[0] != "col" or y.shape[-1] == self.out_features:
            return None
        return self.tp[1], self.tp[2]
