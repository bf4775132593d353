"""UNETR encoder/decoder blocks (counterpart of
`miseg_tpu/nn/unetr_blocks.py:23-82`), 2-D or 3-D by `spatial_dims`.
`fused_conv` selects the conv blocks' path (see `nn/dynunet.py`)."""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from .dynunet import UnetBasicBlock, UnetResBlock, _conv

NormSpec = tuple[str, dict[str, Any]] | str


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 norm: NormSpec = ("instance", {}), res_block: bool = False,
                 *, fused_conv: bool = True, spatial_dims: int = 3, device=None,
                 dtype=None):
        super().__init__()
        block = UnetResBlock if res_block else UnetBasicBlock
        self.layer = block(in_channels, out_channels, kernel_size, stride,
                           norm, fused_conv=fused_conv, spatial_dims=spatial_dims,
                           device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        return self.layer(x, modalities)


class UnetrUpBlock(nn.Module):
    """transp-conv x2 upsample -> concat skip -> conv block."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 upsample_kernel_size: int | Sequence[int] = 2,
                 norm: NormSpec = ("instance", {}), res_block: bool = False,
                 *, fused_conv: bool = True, spatial_dims: int = 3, device=None,
                 dtype=None):
        super().__init__()
        dd = dict(spatial_dims=spatial_dims, device=device, dtype=dtype)
        self.transp_conv = _conv(in_channels, out_channels,
                                 upsample_kernel_size, upsample_kernel_size,
                                 transposed=True, **dd)
        block = UnetResBlock if res_block else UnetBasicBlock
        self.conv_block = block(2 * out_channels, out_channels, kernel_size,
                                1, norm, fused_conv=fused_conv, **dd)

    def forward(self, x, skip, modalities=None):
        out = torch.cat([self.transp_conv(x), skip], dim=-1)
        return self.conv_block(out, modalities)


class UnetrPrUpBlock(nn.Module):
    """Progressive up-projection: `transp_conv_init`, then `num_layer` x
    (transposed conv `up{i}` [-> conv block `block{i}`])."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int = 2,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 upsample_kernel_size: int | Sequence[int] = 2,
                 norm: NormSpec = ("instance", {}), conv_block: bool = False,
                 res_block: bool = False, *, fused_conv: bool = True,
                 spatial_dims: int = 3, device=None, dtype=None):
        super().__init__()
        dd = dict(spatial_dims=spatial_dims, device=device, dtype=dtype)
        self.num_layer, self.conv_block = num_layer, conv_block
        self.transp_conv_init = _conv(in_channels, out_channels, upsample_kernel_size,
                                      upsample_kernel_size, transposed=True, **dd)
        block = UnetResBlock if res_block else UnetBasicBlock
        for i in range(num_layer):
            self.add_module(f"up{i}", _conv(out_channels, out_channels, upsample_kernel_size,
                                            upsample_kernel_size, transposed=True, **dd))
            if conv_block:
                self.add_module(f"block{i}", block(out_channels, out_channels, kernel_size,
                                                   stride, norm, fused_conv=fused_conv, **dd))

    def forward(self, x, modalities=None):
        x = self.transp_conv_init(x)
        for i in range(self.num_layer):
            x = getattr(self, f"up{i}")(x)
            if self.conv_block:
                x = getattr(self, f"block{i}")(x, modalities)
        return x
