"""Channel-last 3-D convolutions (counterpart of
`miseg_tpu/nn/convolutions.py:49-135`, the `conv_only` path).

A contiguous `[B, D, H, W, C]` tensor viewed through
`permute(0, 4, 1, 2, 3)` is already a `channels_last_3d` NCDHW tensor, so
`F.conv3d` runs on it without a copy and its channels-last output
permutes back the same way.  Weights use torch's layout: `[O, I, *k]` for
a conv, `[I, O, *k]` for a transposed conv.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import fill_, lecun_normal


def _tuple3(v) -> tuple[int, int, int]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) if len(v) == 3 else (int(v[0]),) * 3
    return (int(v),) * 3


def get_padding(kernel_size, stride):
    """dynunet padding rule: (k - s + 1) // 2, per dim."""
    k = kernel_size if isinstance(kernel_size, (list, tuple)) else (kernel_size,)
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * len(k)
    pads = tuple(int((ki - si + 1) / 2) for ki, si in zip(k, s))
    if min(pads) < 0:
        raise ValueError("negative padding; change kernel size / stride")
    return pads


def get_output_padding(kernel_size, stride, padding):
    """dynunet transposed-conv rule: 2p + s - k."""
    k = kernel_size if isinstance(kernel_size, (list, tuple)) else (kernel_size,)
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * len(k)
    p = padding if isinstance(padding, (list, tuple)) else (padding,) * len(k)
    out = tuple(2 * pi + si - ki for ki, si, pi in zip(k, s, p))
    if min(out) < 0:
        raise ValueError("negative output padding; change kernel size / stride")
    return out


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _cl(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv_transpose(x: torch.Tensor, weight: torch.Tensor, strides: Sequence[int],
                   padding: Sequence[int], output_padding: Sequence[int],
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Channel-last transposed conv with torch padding semantics."""
    return _cl(F.conv_transpose3d(_cf(x), weight, bias, tuple(strides),
                                  tuple(padding), tuple(output_padding)))


class Conv(nn.Module):
    """Channel-last conv (flax `nn.Conv` counterpart: `weight` = kernel)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        self.kernel_size = _tuple3(kernel_size)
        self.stride, self.padding = _tuple3(stride), _tuple3(padding)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels, *self.kernel_size), device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype))
                     if bias else None)

    def init_parameters(self, generator) -> None:
        fan_in = self.weight.shape[1] * math.prod(self.kernel_size)
        fill_(self.weight, lecun_normal(self.weight.shape, fan_in, generator))
        if self.bias is not None:
            fill_(self.bias, torch.zeros(self.bias.shape))

    def forward(self, x):
        return _cl(F.conv3d(_cf(x), self.weight, self.bias, self.stride,
                            self.padding))


class Convolution(nn.Module):
    """`conv_only` Convolution: a `Conv` named `conv`, or, transposed, the
    `weight [I, O, *k]` held directly (the flax tree's layout)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 strides=1, padding=None, output_padding=None,
                 use_bias: bool = True, is_transposed: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        k, s = _tuple3(kernel_size), _tuple3(strides)
        pad = _tuple3(padding) if padding is not None else tuple((ki - 1) // 2 for ki in k)
        self.is_transposed = is_transposed
        if is_transposed:
            self.kernel_size, self.strides, self.padding = k, s, pad
            self.output_padding = (_tuple3(output_padding) if output_padding is not None
                                   else tuple(si - 1 for si in s))
            self.weight = nn.Parameter(torch.empty(
                (in_channels, out_channels, *k), device=device, dtype=dtype))
            self.bias = (nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype))
                         if use_bias else None)
        else:
            self.conv = Conv(in_channels, out_channels, k, s, pad, use_bias,
                             device=device, dtype=dtype)

    def init_parameters(self, generator) -> None:
        if self.is_transposed:
            # flax computes fan_in over the kernel's leading [*k, I] axes
            fan_in = self.weight.shape[0] * math.prod(self.kernel_size)
            fill_(self.weight, lecun_normal(self.weight.shape, fan_in, generator))
            if self.bias is not None:
                fill_(self.bias, torch.zeros(self.bias.shape))

    def forward(self, x):
        if self.is_transposed:
            return conv_transpose(x, self.weight, self.strides, self.padding,
                                  self.output_padding, self.bias)
        return self.conv(x)
