"""UNETR encoder/decoder blocks (counterpart of
`miseg_tpu/nn/unetr_blocks.py:23-55`).  `fused_conv` selects the conv
block's path (see `nn/dynunet.py`)."""

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
                 *, fused_conv: bool = True, device=None, dtype=None):
        super().__init__()
        block = UnetResBlock if res_block else UnetBasicBlock
        self.layer = block(in_channels, out_channels, kernel_size, stride,
                           norm, fused_conv=fused_conv, device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        return self.layer(x, modalities)


class UnetrUpBlock(nn.Module):
    """transp-conv x2 upsample -> concat skip -> conv block."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 upsample_kernel_size: int | Sequence[int] = 2,
                 norm: NormSpec = ("instance", {}), res_block: bool = False,
                 *, fused_conv: bool = True, device=None, dtype=None):
        super().__init__()
        self.transp_conv = _conv(in_channels, out_channels,
                                 upsample_kernel_size, upsample_kernel_size,
                                 transposed=True, device=device, dtype=dtype)
        block = UnetResBlock if res_block else UnetBasicBlock
        self.conv_block = block(2 * out_channels, out_channels, kernel_size,
                                1, norm, fused_conv=fused_conv, device=device,
                                dtype=dtype)

    def forward(self, x, skip, modalities=None):
        out = torch.cat([self.transp_conv(x), skip], dim=-1)
        return self.conv_block(out, modalities)
