"""The residual UNets (counterpart of `miseg_tpu/models/unet.py`).

* `UNet` ("C-UNet" with `instance_cond` encoder norms): a recursion of
  levels, each `down` -> `sub` (the next level) or `bottom` -> a skip
  concatenation -> a transposed `up` conv -> `up_ru` (a one-subunit
  ResidualUnit when `num_res_units` > 0).  Encoder layers take
  `norm_down`, decoder layers `norm_up`.  The top level's `up` is
  conv-only when `num_res_units` == 0 and its `up_ru` last-conv-only.
  Module names follow the flax tree: `model.down`, `model.sub.down`, ...,
  `model.sub.sub.bottom` at four channels.
* `UNetVanilla`: `pre_conv` (conv only), a down path of ResidualUnits
  (`down_path_{scale}_{i}`, `num_res_units` a scale, the first strided),
  an up path of nearest-neighbour upsampling, concatenation `[skip, x]`
  and a ResidualUnit (`up_path_{i}`), and a 1x1 `out` conv.  `channels`
  is the whole per-scale list (the reference's prediction recipe:
  16 64 128 256 512, strides 1 2 2 2 1).

Every instance norm runs K1 + K2; the convs are cuDNN's (the JAX package
never sends a UNet conv to its fused conv kernel).  Both build 2-D or 3-D
by `spatial_dims` (the JAX modules take it from the input).

Under spatial partitioning (`parallel/spatial.py`) the convs, norms and
transposed convs take their halos, merged statistics and level states
themselves; UNetVanilla's upsampling is local on a slab but changes the
level, so its output is `settle`d (a whole input sliced where the new
level is sharded), and each `torch.cat` joins two tensors in one state.
"""

from __future__ import annotations

import warnings
from typing import Any, Sequence

import torch
from torch import nn

from ..nn.convolutions import Convolution, ResidualUnit
from ..parallel import spatial

NormSpec = tuple[str, dict[str, Any]] | str


class _UNetLevel(nn.Module):
    """One recursion level: down -> [x, sub or bottom of x] -> up (-> up_ru).
    The sub level sits under its parent in the flax tree: the reference's
    `SkipConnection` holds no parameters, and its `cat` is a `torch.cat`."""

    def __init__(self, in_channels: int, out_channels: int, channels: Sequence[int],
                 strides: Sequence[int], is_top: bool, *, kernel_size, up_kernel_size,
                 num_res_units: int, act, norm_down: NormSpec, norm_up: NormSpec,
                 dropout: float, bias: bool, adn_ordering: str, spatial_dims: int = 3,
                 device=None, dtype=None):
        super().__init__()
        common = dict(act=act, dropout=dropout or None, adn_ordering=adn_ordering,
                      spatial_dims=spatial_dims, device=device, dtype=dtype)
        c, s = channels[0], strides[0]

        def down(cin, cout, stride):
            if num_res_units > 0:
                return ResidualUnit(cin, cout, kernel_size, stride, num_res_units,
                                    norm=norm_down, use_bias=bias, **common)
            return Convolution(cin, cout, kernel_size, stride, use_bias=bias,
                               norm=norm_down, **common)

        self.down = down(in_channels, c, s)
        if len(channels) > 2:
            self.sub = _UNetLevel(
                c, c, channels[1:], strides[1:], False, kernel_size=kernel_size,
                up_kernel_size=up_kernel_size, num_res_units=num_res_units, act=act,
                norm_down=norm_down, norm_up=norm_up, dropout=dropout, bias=bias,
                adn_ordering=adn_ordering, spatial_dims=spatial_dims, device=device,
                dtype=dtype)
            sub_out = c
        else:
            self.bottom = down(c, channels[1], 1)
            sub_out = channels[1]
        self.up = Convolution(c + sub_out, out_channels, up_kernel_size, s, use_bias=bias,
                              is_transposed=True, norm=norm_up,
                              conv_only=is_top and num_res_units == 0, **common)
        self.up_ru = None
        if num_res_units > 0:
            self.up_ru = ResidualUnit(out_channels, out_channels, kernel_size, 1, 1,
                                      norm=norm_up, use_bias=bias, last_conv_only=is_top,
                                      **common)

    def forward(self, x, modalities=None):
        x = self.down(x, modalities)
        inner = self.sub if hasattr(self, "sub") else self.bottom
        x = self.up(torch.cat([x, inner(x, modalities)], -1), modalities)
        return x if self.up_ru is None else self.up_ru(x, modalities)


class UNet(nn.Module):
    # every down layer and the bottom block at any depth; fnmatch patterns
    # over the '/'-joined path (train/optim.freeze_mask)
    ENCODER_PREFIXES = ("*/down/*", "*/bottom/*")

    def __init__(self, in_channels: int, out_channels: int, channels: Sequence[int],
                 strides: Sequence[int], kernel_size: int | Sequence[int] = 3,
                 up_kernel_size: int | Sequence[int] = 3, num_res_units: int = 0,
                 act: str | tuple = "prelu", norm_down: NormSpec = ("instance", {}),
                 norm_up: NormSpec = ("instance", {}), dropout: float = 0.0,
                 bias: bool = True, adn_ordering: str = "NDA", *, spatial_dims: int = 3,
                 device=None, dtype=None):
        super().__init__()
        if len(channels) < 2:
            raise ValueError("the length of `channels` should be no less than 2.")
        delta = len(strides) - (len(channels) - 1)
        if delta < 0:
            raise ValueError("the length of `strides` should equal to `len(channels) - 1`.")
        if delta > 0:
            warnings.warn(f"`len(strides) > len(channels) - 1`, the last {delta} values of "
                          "strides will not be used.")
        self.model = _UNetLevel(
            in_channels, out_channels, tuple(channels), tuple(strides[:len(channels) - 1]),
            True, kernel_size=kernel_size, up_kernel_size=up_kernel_size,
            num_res_units=num_res_units, act=act, norm_down=norm_down, norm_up=norm_up,
            dropout=float(dropout), bias=bias, adn_ordering=adn_ordering,
            spatial_dims=spatial_dims, device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        """`x [B, *spatial, Cin]`, `modalities int[B]` -> logits
        `[B, *spatial, out_channels]`."""
        return self.model(x, modalities)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of `[B, *spatial, C]` by an integer
    factor on every spatial axis (`jnp.repeat`, exactly)."""
    if factor == 1:
        return x
    for dim in range(1, x.ndim - 1):
        x = x.repeat_interleave(factor, dim=dim)
    return x


class UNetVanilla(nn.Module):
    ENCODER_PREFIXES = ("pre_conv", "down_path")

    def __init__(self, in_channels: int, out_channels: int, channels: Sequence[int],
                 strides: Sequence[int], kernel_size: int | Sequence[int] = 3,
                 up_kernel_size: int | Sequence[int] = 3, num_res_units: int = 0,
                 act: str | tuple = "prelu", norm_down: NormSpec = ("instance", {}),
                 norm_up: NormSpec = ("instance", {}), dropout: float = 0.0,
                 bias: bool = True, adn_ordering: str = "NDA", *, spatial_dims: int = 3,
                 device=None, dtype=None):
        super().__init__()
        ch, self.strides = list(channels), list(strides)
        if len(self.strides) < len(ch):
            raise ValueError(f"UNetVanilla takes a stride a scale: {len(ch)} channels, "
                             f"{len(self.strides)} strides")
        dd = dict(spatial_dims=spatial_dims, device=device, dtype=dtype)

        def unit(cin, cout, stride, norm):
            return ResidualUnit(cin, cout, kernel_size, stride, 2, adn_ordering, act, norm,
                                dropout or None, bias, **dd)

        self.pre_conv = Convolution(in_channels, ch[0], kernel_size, self.strides[0],
                                    conv_only=True, **dd)
        self.num_res_units = num_res_units
        for scale in range(1, len(ch)):
            setattr(self, f"down_path_{scale - 1}_0",
                    unit(ch[scale - 1], ch[scale], self.strides[scale], norm_down))
            for i in range(1, num_res_units):
                setattr(self, f"down_path_{scale - 1}_{i}",
                        unit(ch[scale], ch[scale], 1, norm_down))
        for idx, scale in enumerate(range(len(ch) - 2, -1, -1)):
            setattr(self, f"up_path_{idx}", unit(ch[scale] + ch[scale + 1], ch[scale], 1,
                                                 norm_up))
        self.out = Convolution(ch[0], out_channels, 1, 1, conv_only=True, **dd)
        self.scales = len(ch)

    def forward(self, x, modalities=None):
        """`x [B, *spatial, Cin]`, `modalities int[B]` -> logits
        `[B, *spatial, out_channels]`."""
        x = self.pre_conv(x)
        skips = [x]
        for scale in range(1, self.scales):
            for i in range(max(1, self.num_res_units)):
                x = getattr(self, f"down_path_{scale - 1}_{i}")(x, modalities)
            skips.append(x)
        for idx, scale in enumerate(range(self.scales - 2, -1, -1)):
            slab = spatial.line_of(x) is not None
            x = spatial.settle(nearest_upsample(x, self.strides[scale + 1]), slab)
            x = getattr(self, f"up_path_{idx}")(torch.cat([skips[scale], x], dim=-1),
                                                modalities)
        return self.out(x)
