"""Channel-last 2-D and 3-D convolutions (counterpart of
`miseg_tpu/nn/convolutions.py:49-184`): `Conv`, `Convolution` with its
optional ADN, and `ResidualUnit`.

A contiguous `[B, D, H, W, C]` tensor viewed through
`permute(0, 4, 1, 2, 3)` is already a `channels_last_3d` NCDHW tensor, so
`F.conv3d` runs on it without a copy and its channels-last output
permutes back the same way; a `[B, H, W, C]` one is a `channels_last`
NCHW tensor for `F.conv2d` alike.  The JAX modules take their rank from
the input; these build their weights at construction, so they take it
from `spatial_dims` (default 3), or from a kernel size given as one
entry a dim.  Weights use torch's layout: `[O, I, *k]` for
a conv, `[I, O, *k]` for a transposed conv.  The convs are cuDNN's, as
the JAX package's are XLA's `nn.Conv` and `lax.conv_transpose`.

Under spatial partitioning (`parallel/spatial.py`) a conv of a D slab
(an H slab in 2-D) reads the planes of its neighbours that its kernel
reaches (`halo_d`: one low plane for a k3 s2 p1 conv, one a side for k3
s1 p1, one high plane for C-UNet's transposed k3 s2 p1 op1 conv, none
for the k2 s2 and 1x1 convs), runs without padding on that dim and keeps its
slab's planes of the output; then its output takes its own level's state
(`spatial.settle`: gathered where that level is whole, a whole input's
output sliced where its level is sharded).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import fill_, lecun_normal
from ..parallel import spatial
from .adn import ADN


def _tuple(v, nd: int) -> tuple[int, ...]:
    """`v` (an int, a one-entry list or one entry a dim) as `nd` ints."""
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]),) * nd
        if len(v) != nd:
            raise ValueError(f"expected length-{nd} sequence, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * nd


def _rank(kernel_size, spatial_dims: int) -> int:
    """The spatial rank: a kernel size's own length where it gives one."""
    if isinstance(kernel_size, (list, tuple)) and len(kernel_size) > 1:
        return len(kernel_size)
    if spatial_dims not in (2, 3):
        raise ValueError(f"spatial_dims should be 2 or 3, got {spatial_dims}")
    return spatial_dims


def same_padding(kernel_size):
    """Padding that keeps the spatial size at stride 1: (k - 1) / 2, for odd
    kernel sizes only."""
    k = kernel_size if isinstance(kernel_size, (list, tuple)) else (kernel_size,)
    if any(ki % 2 == 0 for ki in k):
        raise NotImplementedError("same padding requires odd kernel sizes")
    return tuple((ki - 1) // 2 for ki in k)


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
    return x.movedim(-1, 1)


def _cl(y: torch.Tensor) -> torch.Tensor:
    return y.movedim(1, -1).contiguous()


_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def conv_transpose(x: torch.Tensor, weight: torch.Tensor, strides: Sequence[int],
                   padding: Sequence[int], output_padding: Sequence[int],
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Channel-last 2-D or 3-D transposed conv with torch padding semantics
    (on a D slab under spatial partitioning: its halo, then its slab of
    the output, `settle`d)."""
    line = spatial.line_of(x)
    if line is None:
        return spatial.settle(_cl(_CONV_T[x.ndim - 2](_cf(x), weight, bias, tuple(strides),
                                                      tuple(padding), tuple(output_padding))),
                              False)
    k, s, p = weight.shape[2], strides[0], padding[0]
    lo, hi = spatial.conv_dims(k, s, p, transposed=True)
    d = x.shape[1]
    y = _cl(_CONV_T[x.ndim - 2](_cf(spatial.halo_d(x, lo, hi, line)), weight, bias,
                                tuple(strides), (p, *padding[1:]), (0, *output_padding[1:])))
    if y.shape[1] < s * (lo + d):
        # k >= s + 2p - s * hi keeps every slab whole: the models' k2 s2 p0
        # (UNETR's and the swin's up-blocks) and k3 s2 p1 (C-UNet's up-convs)
        raise ValueError(f"spatial partitioning: a transposed conv k{k} s{s} p{p} leaves "
                         f"its {s * d}-plane slab short by {s * (lo + d) - y.shape[1]}; no "
                         "model the port builds has one")
    return spatial.settle(y.narrow(1, s * lo, s * d).contiguous(), True)


class Conv(nn.Module):
    """Channel-last conv (flax `nn.Conv` counterpart: `weight` = kernel)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias: bool = True, *, spatial_dims: int = 3,
                 device=None, dtype=None):
        super().__init__()
        nd = _rank(kernel_size, spatial_dims)
        self.kernel_size = _tuple(kernel_size, nd)
        self.stride, self.padding = _tuple(stride, nd), _tuple(padding, nd)
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
        line = spatial.line_of(x)
        if line is None:
            return spatial.settle(_cl(_CONV[len(self.kernel_size)](
                _cf(x), self.weight, self.bias, self.stride, self.padding)), False)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        if x.shape[1] % s:
            raise ValueError(f"spatial partitioning: a stride-{s} conv over a slab of "
                             f"{x.shape[1]} planes")
        lo, hi = spatial.conv_dims(k, s, p)
        xh = spatial.halo_d(x, lo, hi, line)
        return spatial.settle(_cl(_CONV[len(self.kernel_size)](
            _cf(xh), self.weight, self.bias, self.stride, (0, *self.padding[1:]))), True)


class Convolution(nn.Module):
    """(Conv | transposed conv) -> optional ADN.  The conv is a `Conv`
    named `conv`, or, transposed, the `weight [I, O, *k]` held directly
    (the flax tree's layout); padding defaults to `same_padding`, a
    transposed conv's output padding to `stride - 1`.  The ADN (`adn`) is
    built unless `conv_only` or act, norm and dropout are all None, so the
    defaults give the conv alone."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 strides=1, padding=None, output_padding=None,
                 use_bias: bool = True, is_transposed: bool = False, *,
                 adn_ordering: str = "NDA", act=None, norm=None,
                 dropout: float | None = None, conv_only: bool = False,
                 spatial_dims: int = 3, device=None, dtype=None):
        super().__init__()
        nd = _rank(kernel_size, spatial_dims)
        k, s = _tuple(kernel_size, nd), _tuple(strides, nd)
        pad = _tuple(padding, nd) if padding is not None else same_padding(k)
        self.is_transposed = is_transposed
        if is_transposed:
            self.kernel_size, self.strides, self.padding = k, s, pad
            self.output_padding = (_tuple(output_padding, nd) if output_padding is not None
                                   else tuple(si - 1 for si in s))
            self.weight = nn.Parameter(torch.empty(
                (in_channels, out_channels, *k), device=device, dtype=dtype))
            self.bias = (nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype))
                         if use_bias else None)
        else:
            self.conv = Conv(in_channels, out_channels, k, s, pad, use_bias,
                             device=device, dtype=dtype)
        self.adn = None
        if not (conv_only or (act is None and norm is None and not dropout)):
            self.adn = ADN(out_channels, adn_ordering, act, norm, dropout,
                           device=device, dtype=dtype)

    def init_parameters(self, generator) -> None:
        if self.is_transposed:
            # flax computes fan_in over the kernel's leading [*k, I] axes
            fan_in = self.weight.shape[0] * math.prod(self.kernel_size)
            fill_(self.weight, lecun_normal(self.weight.shape, fan_in, generator))
            if self.bias is not None:
                fill_(self.bias, torch.zeros(self.bias.shape))

    def forward(self, x, modalities=None):
        if self.is_transposed:
            x = conv_transpose(x, self.weight, self.strides, self.padding,
                               self.output_padding, self.bias)
        else:
            x = self.conv(x)
        return x if self.adn is None else self.adn(x, modalities)


class ResidualUnit(nn.Module):
    """`subunits` x Convolution (`unit0`, `unit1`, ...; the first strided,
    the last conv-only with `last_conv_only`) plus a residual: a `Conv`
    named `residual` with the unit's kernel and stride when a stride is not
    1, a 1x1 one when only the channels change, else the identity."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, strides=1,
                 subunits: int = 2, adn_ordering: str = "NDA", act="prelu",
                 norm=("instance", {}), dropout: float | None = None,
                 use_bias: bool = True, last_conv_only: bool = False, *,
                 spatial_dims: int = 3, device=None, dtype=None):
        super().__init__()
        nd = _rank(kernel_size, spatial_dims)
        k, s = _tuple(kernel_size, nd), _tuple(strides, nd)
        pad = same_padding(k)
        self.subunits = max(1, subunits)
        cin, ss = in_channels, s
        for su in range(self.subunits):
            setattr(self, f"unit{su}", Convolution(
                cin, out_channels, k, ss, pad, use_bias=use_bias,
                adn_ordering=adn_ordering, act=act, norm=norm, dropout=dropout,
                conv_only=last_conv_only and su == self.subunits - 1,
                device=device, dtype=dtype))
            cin, ss = out_channels, (1,) * nd
        self.residual = None
        strided = any(si != 1 for si in s)
        if strided or in_channels != out_channels:
            rk, rp = (k, pad) if strided else ((1,) * nd, (0,) * nd)
            self.residual = Conv(in_channels, out_channels, rk, s, rp, use_bias,
                                 device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        cx = x
        for su in range(self.subunits):
            cx = getattr(self, f"unit{su}")(cx, modalities)
        return cx + (x if self.residual is None else self.residual(x))
