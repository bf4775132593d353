"""DynUNet blocks (counterpart of
`miseg_tpu/nn/dynunet.py:30-37,74-258`).

Two paths compute the same function with the same parameters:
  * the fused conv chain (`_fuse_plan`, `_fused`; the default,
    `fused_conv=True`): conv1 through K4, conv2 through K4 with norm1 and
    the leaky-relu applied on read, and the tail through K3 (UnetResBlock
    with a projected residual) or K2 (an identity residual added by K2's
    add mode; UnetBasicBlock), every norm's statistics coming from K4's
    epilogue (`ops.kernels.fused_conv`);
  * the unfused path (`fused_conv=False`, or a block the plan rejects):
    cuDNN convs, each norm through K1 + K2 with the leaky-relu tails fused
    into K2 (norm1 + act; norm2 + residual add + act).
`fused_conv` is the caller's choice, the counterpart of the JAX package's
`MISEG_PALLAS_CONV`; it is never a fallback for a kernel that fails.
A 2-D block (`spatial_dims=2`) takes the unfused path: K4 is 3-D only
(`fused_conv.supported` is False for a 4-D input), as the JAX package's
Pallas conv is.  A
block built with a `dropout` rate drops after norm1 (+ act) in training,
which the fused chain cannot: the plan rejects it there, as the JAX
package's does (miseg_tpu/nn/dynunet.py:85).  No block of SwinUNETR takes
one.

Under spatial partitioning (`parallel/spatial.py`) a block on a D slab
runs K4 in its D-halo mode (`spatial.conv3_halo`: one plane of each
neighbour through `halo_d`, the fold's moments merged over the line, the
columns folded from them), K3 / K2 on those merged columns, and the 1x1
projection locally with its norm's statistics merged
(`spatial.instance_columns`); the unfused path's convs and norms take
their halos and merged statistics in `Conv` and `Norm`.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..ops.kernels import fused_conv, fused_norm
from ..parallel import spatial
from .convolutions import Convolution, get_output_padding, get_padding
from .dropout import Dropout
from .factories import get_act, leaky_slope
from .norms import make_norm

NormSpec = tuple[str, dict[str, Any]] | str
_LRELU = ("leakyrelu", {"negative_slope": 0.01})


def _conv(in_channels, out_channels, kernel_size, stride, *, transposed=False,
          bias=False, spatial_dims=3, device=None, dtype=None):
    """dynunet conv: explicit padding rule, no ADN."""
    pad = get_padding(kernel_size, stride)
    out_pad = get_output_padding(kernel_size, stride, pad) if transposed else None
    return Convolution(in_channels, out_channels, kernel_size, stride, pad,
                       out_pad, use_bias=bias, is_transposed=transposed,
                       spatial_dims=spatial_dims, device=device, dtype=dtype)


def _is_downsample(in_channels, out_channels, stride) -> bool:
    s = stride if isinstance(stride, (list, tuple)) else (stride,)
    return in_channels != out_channels or any(si != 1 for si in s)


def _fuse_plan(block, x, modalities):
    """`(styles,)` when the block runs through the fused conv chain, else
    None (miseg_tpu/nn/dynunet.py:74-95 without its TPU-only VMEM and
    lane-density conditions): the caller asked for it, no dropout acts
    (a rate above 0 in training), the act is a leaky relu, the norm an
    affine `instance` or an `instance_cond` that has its modalities, and K4
    computes the conv's geometry."""
    norm = block.norm1
    if (not block.fused_conv or block.slope is None
            or (block.drop.rate and block.training)
            or norm.kind not in ("instance", "instance_cond") or norm.scale is None
            or (norm.kind == "instance_cond" and modalities is None)
            or not fused_conv.supported(_k4_shape(x), block.kernel_size, block.stride,
                                        halo=spatial.line_of(x) is not None)):
        return None
    return (modalities if norm.kind == "instance_cond" else None,)


def _k4_shape(x) -> tuple[int, ...]:
    """The input shape K4 sees: a slab's with its two halo planes."""
    if spatial.line_of(x) is None:
        return tuple(x.shape)
    return (x.shape[0], x.shape[1] + 2, *x.shape[2:])


def _fused_convs(block, x, styles):
    """conv1 -> [norm1 + act on read] conv2, both through K4: returns y2
    and norm2's columns (on a slab, K4's D-halo mode with the columns of
    the whole volume's statistics)."""
    n1, n2 = block.norm1, block.norm2
    line = spatial.line_of(x)
    if line is not None:
        w1, w2 = block.conv1.conv.weight, block.conv2.conv.weight
        y1, *mom1 = spatial.conv3_halo(x, w1, line=line)
        sc1, sh1 = fused_norm.columns_from_moments(*mom1, n1.scale, n1.bias, styles, eps=n1.eps)
        y2, *mom2 = spatial.conv3_halo(y1, w2, sc1, sh1, slope=block.slope, line=line)
        return (y2, *fused_norm.columns_from_moments(*mom2, n2.scale, n2.bias, styles,
                                                     eps=n2.eps))
    y1, sc1, sh1 = fused_conv.conv3_norm_columns(
        x, block.conv1.conv.weight, gamma=n1.scale, beta=n1.bias, styles=styles,
        eps=n1.eps)
    return fused_conv.conv3_norm_columns(
        y1, block.conv2.conv.weight, sc1, sh1, slope=block.slope, gamma=n2.scale,
        beta=n2.bias, styles=styles, eps=n2.eps)


class UnetResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 norm: NormSpec = ("instance", {}), act=_LRELU,
                 dropout: float | None = None, *, fused_conv: bool = True,
                 spatial_dims: int = 3, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        cd = dict(dd, spatial_dims=spatial_dims)
        self.kernel_size, self.stride, self.fused_conv = kernel_size, stride, fused_conv
        self.drop = Dropout(dropout or 0.0)
        self.slope = leaky_slope(act)
        self.act = get_act(act) if self.slope is None else None
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride, **cd)
        self.norm1 = make_norm(norm, out_channels, **dd)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1, **cd)
        self.norm2 = make_norm(norm, out_channels, **dd)
        self.downsample = _is_downsample(in_channels, out_channels, stride)
        if self.downsample:
            self.conv3 = _conv(in_channels, out_channels, 1, stride, **cd)
            self.norm3 = make_norm(norm, out_channels, **dd)

    def forward(self, x, modalities=None):
        plan = _fuse_plan(self, x, modalities)
        if plan is not None:
            return self._fused(x, *plan)
        out = self.norm1(self.conv1(x), modalities, act_slope=self.slope)
        if self.act is not None:
            out = self.act(out)
        out = self.conv2(self.drop(out))
        residual = x
        if self.downsample:
            residual = self.norm3(self.conv3(x), modalities)
        if self.act is None:
            return self.norm2(out, modalities, act_slope=self.slope, add=residual)
        return self.act(self.norm2(out, modalities) + residual)

    def _fused(self, x, styles):
        """K4, K4, then the tail (miseg_tpu/nn/dynunet.py:142-175): K3 with
        the projected residual's columns, or, for an identity residual, K2
        adding x itself (JAX's K3 with ones/zeros columns: `x * 1 + 0 == x`
        in f32)."""
        y2, sc2, sh2 = _fused_convs(self, x, styles)
        bsz, cout = x.shape[0], y2.shape[-1]
        if not self.downsample:
            y3 = y2.reshape(bsz, -1, cout)
            return fused_norm.apply_scale_shift(
                y3, sc2, sh2, x.reshape(y3.shape), negative_slope=self.slope).reshape(y2.shape)
        w3 = self.conv3.conv.weight   # a 1x1 conv: the plan accepts stride 1 only
        res = torch.matmul(x, w3.reshape(cout, -1).t().to(x.dtype))
        n3 = self.norm3
        sc3, sh3 = spatial.instance_columns(res, n3.scale, n3.bias, styles, eps=n3.eps)
        return fused_norm.apply_norm2_act(y2, sc2, sh2, res, sc3, sh3,
                                          negative_slope=self.slope)


class UnetBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 norm: NormSpec = ("instance", {}), act=_LRELU,
                 dropout: float | None = None, *, fused_conv: bool = True,
                 spatial_dims: int = 3, device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        cd = dict(dd, spatial_dims=spatial_dims)
        self.kernel_size, self.stride, self.fused_conv = kernel_size, stride, fused_conv
        self.drop = Dropout(dropout or 0.0)
        self.slope = leaky_slope(act)
        self.act = get_act(act) if self.slope is None else None
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride, **cd)
        self.norm1 = make_norm(norm, out_channels, **dd)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1, **cd)
        self.norm2 = make_norm(norm, out_channels, **dd)

    def forward(self, x, modalities=None):
        plan = _fuse_plan(self, x, modalities)
        if plan is not None:
            return self._fused(x, *plan)
        out = self.norm1(self.conv1(x), modalities, act_slope=self.slope)
        if self.act is not None:
            out = self.act(out)
        out = self.norm2(self.conv2(self.drop(out)), modalities, act_slope=self.slope)
        return self.act(out) if self.act is not None else out

    def _fused(self, x, styles):
        """K4, K4, then K2 (miseg_tpu/nn/dynunet.py:207-225)."""
        y2, sc2, sh2 = _fused_convs(self, x, styles)
        return fused_norm.apply_norm_act(y2, sc2, sh2, negative_slope=self.slope)


class UnetOutBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *, spatial_dims: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, 1, 1, bias=True,
                          spatial_dims=spatial_dims, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)
