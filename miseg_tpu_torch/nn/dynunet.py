"""DynUNet blocks, unfused path (counterpart of
`miseg_tpu/nn/dynunet.py:30-37,98-140,178-205,250-258`).

The leaky-relu tails fuse into the norms' K2 pass (norm1 + act;
norm2 + residual add + act).  The fused conv chain (`_fuse_plan` /
`_fused`: kernels K3, K4) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence

from torch import nn

from .convolutions import Convolution, get_output_padding, get_padding
from .factories import get_act, leaky_slope
from .norms import make_norm

NormSpec = tuple[str, dict[str, Any]] | str
_LRELU = ("leakyrelu", {"negative_slope": 0.01})


def _conv(in_channels, out_channels, kernel_size, stride, *, transposed=False,
          bias=False, device=None, dtype=None):
    """dynunet conv: explicit padding rule, no ADN."""
    pad = get_padding(kernel_size, stride)
    out_pad = get_output_padding(kernel_size, stride, pad) if transposed else None
    return Convolution(in_channels, out_channels, kernel_size, stride, pad,
                       out_pad, use_bias=bias, is_transposed=transposed,
                       device=device, dtype=dtype)


def _is_downsample(in_channels, out_channels, stride) -> bool:
    s = stride if isinstance(stride, (list, tuple)) else (stride,)
    return in_channels != out_channels or any(si != 1 for si in s)


class UnetResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 norm: NormSpec = ("instance", {}), act=_LRELU, *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.slope = leaky_slope(act)
        self.act = get_act(act) if self.slope is None else None
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride, **dd)
        self.norm1 = make_norm(norm, out_channels, **dd)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1, **dd)
        self.norm2 = make_norm(norm, out_channels, **dd)
        self.downsample = _is_downsample(in_channels, out_channels, stride)
        if self.downsample:
            self.conv3 = _conv(in_channels, out_channels, 1, stride, **dd)
            self.norm3 = make_norm(norm, out_channels, **dd)

    def forward(self, x, modalities=None):
        out = self.norm1(self.conv1(x), modalities, act_slope=self.slope)
        if self.act is not None:
            out = self.act(out)
        out = self.conv2(out)
        residual = x
        if self.downsample:
            residual = self.norm3(self.conv3(x), modalities)
        if self.act is None:
            return self.norm2(out, modalities, act_slope=self.slope, add=residual)
        return self.act(self.norm2(out, modalities) + residual)


class UnetBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 norm: NormSpec = ("instance", {}), act=_LRELU, *,
                 device=None, dtype=None):
        super().__init__()
        dd = dict(device=device, dtype=dtype)
        self.slope = leaky_slope(act)
        self.act = get_act(act) if self.slope is None else None
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride, **dd)
        self.norm1 = make_norm(norm, out_channels, **dd)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1, **dd)
        self.norm2 = make_norm(norm, out_channels, **dd)

    def forward(self, x, modalities=None):
        out = self.norm1(self.conv1(x), modalities, act_slope=self.slope)
        if self.act is not None:
            out = self.act(out)
        out = self.norm2(self.conv2(out), modalities, act_slope=self.slope)
        return self.act(out) if self.act is not None else out


class UnetOutBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, 1, 1, bias=True,
                          device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)
