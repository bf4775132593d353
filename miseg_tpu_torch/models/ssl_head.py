"""Self-supervised pretraining head over the Swin-ViT backbone
(counterpart of `miseg_tpu/models/ssl_head.py`).

The Swin-ViT (layer norms; its attention is K5) gives the bottom
features `[B, *spatial/32, C]`, C = 16 x feature_size, which feed a
rotation head (Linear C -> 4 on token 0), a contrastive head (Linear
C -> 512 on token 1) and a reconstruction decoder: "vae" (five times a
3x3x3 conv, a parameter-free instance norm with a leaky relu, K1 + K2,
and a x2 trilinear upsample; then a 1x1 conv), "deconv" (five stride-2
transposed convs) or "large_kernel_deconv" (one 32^3 transposed conv).
`spatial_dims=2` builds all of it in 2-D (bilinear upsampling), as the
JAX package's does.
Dormant, as in the JAX package: no entry point builds it.  Modules are
named after the flax paths (`weights.state_dict_from_jax` maps them;
the decoders' transposed convs hold their kernels directly under the
top-level `conv` / `conv_<i>`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convolutions import Convolution
from ..ops.kernels.fused_norm import instance_norm_act
from .swin_transformer import SwinTransformer

UPSAMPLE_MODES = ("vae", "deconv", "large_kernel_deconv")


def trilinear_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """`jax.image.resize(method="linear")` by an integer factor over
    `[B, *spatial, C]` (trilinear in 3-D, bilinear in 2-D): half-pixel
    centres, and at the borders the weights of the pixels inside
    renormalised, which is `F.interpolate`'s `align_corners=False` clamp."""
    mode = {2: "bilinear", 3: "trilinear"}[x.ndim - 2]
    y = F.interpolate(x.movedim(-1, 1), scale_factor=factor, mode=mode,
                      align_corners=False)
    return y.movedim(1, -1).contiguous()


class SSLHead(nn.Module):
    def __init__(self, in_channels: int = 1, feature_size: int = 48,
                 dropout_path_rate: float = 0.0, use_checkpoint: bool = False,
                 spatial_dims: int = 3, upsample: str = "vae", dim: int = 768, *,
                 device=None, dtype=None):
        super().__init__()
        if upsample not in UPSAMPLE_MODES:
            raise ValueError(f"unknown upsample mode {upsample!r}")
        dd = dict(device=device, dtype=dtype)
        nd = spatial_dims
        self.upsample = upsample
        self.swinViT = SwinTransformer(
            in_channels, feature_size, (7,) * nd, (2,) * nd, (2, 2, 2, 2), (3, 6, 12, 24),
            4.0, True, drop_path_rate=dropout_path_rate, norm=("layer", {}),
            use_checkpoint=use_checkpoint, **dd)
        c = feature_size * 2 ** 4   # the bottom stage's channels
        self.rotation_head = nn.Linear(c, 4, **dd)
        self.contrastive_head = nn.Linear(c, 512, **dd)
        dd["spatial_dims"] = nd
        if upsample == "large_kernel_deconv":
            self.conv = Convolution(c, in_channels, 32, 32, 0, 0, is_transposed=True,
                                    conv_only=True, **dd)
        elif upsample == "deconv":
            chans = [c, dim // 2, dim // 4, dim // 8, dim // 16, in_channels]
            for i in range(5):
                setattr(self, f"conv_{i}", Convolution(chans[i], chans[i + 1], 2, 2, 0, 0,
                                                       is_transposed=True, conv_only=True,
                                                       **dd))
        else:
            chans = [c, dim // 2, dim // 4, dim // 8, dim // 16, dim // 16]
            for i in range(5):
                setattr(self, f"conv_{i}", Convolution(chans[i], chans[i + 1], 3, 1,
                                                       conv_only=True, **dd))
            self.conv_out = Convolution(chans[-1], in_channels, 1, 1, conv_only=True, **dd)

    def forward(self, x):
        """x `[B, *spatial, Cin]` -> (rotation logits `[B, 4]`, contrastive
        features `[B, 512]`, reconstruction `[B, *spatial, Cin]`)."""
        h = self.swinViT(x, True)[4]
        tokens = h.reshape(h.shape[0], -1, h.shape[-1])
        x_rot = self.rotation_head(tokens[:, 0])
        x_contrastive = self.contrastive_head(tokens[:, 1])
        if self.upsample == "large_kernel_deconv":
            h = self.conv(h)
        elif self.upsample == "deconv":
            for i in range(5):
                h = getattr(self, f"conv_{i}")(h)
        else:
            for i in range(5):
                h = instance_norm_act(getattr(self, f"conv_{i}")(h), negative_slope=0.01)
                h = trilinear_upsample(h, 2)
            h = self.conv_out(h)
        return x_rot, x_contrastive, h
