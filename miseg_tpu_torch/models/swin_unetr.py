"""Swin-UNETR: hierarchical swin backbone + UNETR-style conv decoder
(counterpart of `miseg_tpu/models/swin_unetr.py:31-118`).  "C-Swin-UNETR"
is this model with `instance_cond` encoder and ViT norms.  Its dropout
rates reach the swin backbone only, as in the JAX package.  With
`fused_conv` (the default) every UnetResBlock runs the fused conv chain
(K4, K4, K3); `fused_conv=False` selects cuDNN convs with K1 + K2 norms.
`use_checkpoint` recomputes in the backward what the JAX package remats:
every swin block and every encoder and decoder block (`nn/recompute.py`).
The rank is `len(img_size)`: 2-D builds 7x7 windows, 2x2 patches and 2-D
convs (cuDNN's: K4 is 3-D only, so `fused_conv` changes nothing there)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn import recompute
from ..nn.dynunet import UnetOutBlock
from ..nn.unetr_blocks import UnetrBasicBlock, UnetrUpBlock
from .swin_transformer import NormSpec, SwinTransformer, _kind


class SwinUNETR(nn.Module):
    # the parameters `freeze_encoder` leaves alone (miseg_tpu/models/swin_unetr.py:48)
    ENCODER_PREFIXES = ("swinViT", "encoder1", "encoder2", "encoder3",
                        "encoder4", "encoder10")

    def __init__(self, img_size: Sequence[int], in_channels: int,
                 out_channels: int, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 feature_size: int = 24, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, dropout_path_rate: float = 0.0,
                 normalize: bool = True,
                 downsample: str = "merging",
                 vit_norm: NormSpec = ("layer", {}),
                 decoder_norm: NormSpec = ("instance", {}),
                 encoder_norm: NormSpec = ("instance", {}), use_checkpoint: bool = False, *,
                 fused_conv: bool = True, device=None, dtype=None):
        super().__init__()
        nd = len(img_size)
        if nd not in (2, 3):
            raise ValueError("spatial dimension should be 2 or 3.")
        if any(m % 32 for m in img_size):
            raise ValueError("input image size (img_size) should be divisible "
                             "by stage-wise image resolution.")
        if feature_size % 12:
            raise ValueError("feature_size should be divisible by 12.")
        for rate, what in ((drop_rate, "dropout rate"), (attn_drop_rate, "attention dropout rate"),
                           (dropout_path_rate, "drop path rate")):
            if not 0 <= rate <= 1:
                raise ValueError(f"{what} should be between 0 and 1.")
        if "layer" in (_kind(decoder_norm), _kind(encoder_norm)):
            raise ValueError("Layer normalization not supported for encoder and "
                             "decoder blocks, please select another normalization.")
        self.normalize, self.use_checkpoint = normalize, use_checkpoint
        self.feature_size = fs = feature_size
        self.drop_rates = (drop_rate, attn_drop_rate, dropout_path_rate)
        dd = dict(device=device, dtype=dtype)
        self.swinViT = SwinTransformer(
            in_channels, fs, (7,) * nd, (2,) * nd, tuple(depths), tuple(num_heads),
            4.0, True, drop_rate, attn_drop_rate, dropout_path_rate,
            downsample=downsample, norm=vit_norm, use_checkpoint=use_checkpoint, **dd)
        dd["spatial_dims"] = nd

        def enc(cin, cout):
            return UnetrBasicBlock(cin, cout, 3, 1, encoder_norm, res_block=True,
                                   fused_conv=fused_conv, **dd)

        def dec(cin, cout):
            return UnetrUpBlock(cin, cout, 3, 2, decoder_norm, res_block=True,
                                fused_conv=fused_conv, **dd)

        self.encoder1 = enc(in_channels, fs)
        self.encoder2 = enc(fs, fs)
        self.encoder3 = enc(2 * fs, 2 * fs)
        self.encoder4 = enc(4 * fs, 4 * fs)
        self.encoder10 = enc(16 * fs, 16 * fs)
        self.decoder5 = dec(16 * fs, 8 * fs)
        self.decoder4 = dec(8 * fs, 4 * fs)
        self.decoder3 = dec(4 * fs, 2 * fs)
        self.decoder2 = dec(2 * fs, fs)
        self.decoder1 = dec(fs, fs)
        self.out = UnetOutBlock(fs, out_channels, **dd)

    def forward(self, x_in, modalities=None):
        """`x_in [B, *spatial, Cin]` (`[B, D, H, W, Cin]` or `[B, H, W,
        Cin]`), `modalities int[B]` -> logits `[B, *spatial, out_channels]`."""
        def block(module, *args):
            return recompute.call(module, *args, modalities, recompute=self.use_checkpoint)

        hidden = self.swinViT(x_in, self.normalize, modalities)
        enc0 = block(self.encoder1, x_in)
        enc1 = block(self.encoder2, hidden[0])
        enc2 = block(self.encoder3, hidden[1])
        enc3 = block(self.encoder4, hidden[2])
        dec4 = block(self.encoder10, hidden[4])
        dec3 = block(self.decoder5, dec4, hidden[3])
        dec2 = block(self.decoder4, dec3, enc3)
        dec1 = block(self.decoder3, dec2, enc2)
        dec0 = block(self.decoder2, dec1, enc1)
        out = block(self.decoder1, dec0, enc0)
        return self.out(out)
