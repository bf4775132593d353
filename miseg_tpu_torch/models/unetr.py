"""UNETR: a ViT encoder and a convolutional UNet decoder (counterpart of
`miseg_tpu/models/unetr.py:29-129`).  "C-UNETR" is this model with
`instance_cond` encoder and ViT norms.

The ViT (16^3 patches, or 16^2 for a 2-D `img_size`) runs on the input; `encoder1` is a conv block on
the input itself, `encoder2`..`encoder4` progressive up-projections of
the hidden states after blocks L/4, L/2 and 3L/4, and the final ViT
output, reshaped to a volume (`proj_feat`, a channel-last reshape), goes
up through four `UnetrUpBlock`s that concatenate those skips; a 1x1x1
conv gives the logits.  With `fused_conv` (the default) every
UnetResBlock runs the fused conv chain (K4, K4, then K3 or K2's add);
`fused_conv=False` selects cuDNN convs with K1 + K2 norms.
`use_checkpoint` recomputes in the backward the blocks the JAX package
remats: `encoder1` and the four decoders (`nn/recompute.py`).

Under spatial partitioning (`parallel/spatial.py`) the ViT runs whole on
every rank: the input slab is gathered (`gather_d`) and the patch
embedding and every block see the whole volume with the partition
suspended, so each rank's ViT gradients are its share of the whole, which
the line's all-reduce sums.  Each token volume (`proj_feat`) is then
`settle`d, sliced where the level rule shards the token level, and
`encoder1` and the decoders run on the slabs.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn import recompute
from ..nn.dynunet import UnetOutBlock
from ..nn.unetr_blocks import UnetrBasicBlock, UnetrPrUpBlock, UnetrUpBlock
from ..parallel import spatial
from .swin_transformer import NormSpec, _kind
from .vit import ViT


class UNETR(nn.Module):
    # the parameters `freeze_encoder` leaves alone (miseg_tpu/models/unetr.py:52)
    ENCODER_PREFIXES = ("vit", "encoder1", "encoder2", "encoder3", "encoder4")

    def __init__(self, in_channels: int, out_channels: int, img_size: Sequence[int],
                 feature_size: int = 16, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_heads: int = 12, num_layers: int = 12, pos_embed: str = "conv",
                 conv_block: bool = True, res_block: bool = True,
                 dropout_rate: float = 0.0, qkv_bias: bool = False,
                 vit_norm: NormSpec = ("layer", {}),
                 decoder_norm: NormSpec = ("instance", {}),
                 encoder_norm: NormSpec = ("instance", {}), use_checkpoint: bool = False,
                 *, fused_conv: bool = True, device=None, dtype=None):
        super().__init__()
        self.use_checkpoint, self.dropout_rate = use_checkpoint, dropout_rate
        if "layer" in (_kind(decoder_norm), _kind(encoder_norm)):
            raise ValueError("Layer normalization not supported for encoder and "
                             "decoder blocks, please select another normalization.")
        if num_layers % 4:
            raise ValueError("num_layers must be a multiple of 4 (skip taps at "
                             "hidden states L/4, L/2, 3L/4).")
        self.needs_modalities = "instance_cond" in (
            _kind(vit_norm), _kind(encoder_norm), _kind(decoder_norm))
        patch_size = (16,) * len(img_size)
        self.feat_size = tuple(s // p for s, p in zip(img_size, patch_size))
        self.hidden_size, self.num_layers = hidden_size, num_layers
        fs = feature_size
        dd = dict(fused_conv=fused_conv, spatial_dims=len(img_size), device=device,
                  dtype=dtype)
        self.vit = ViT(in_channels, img_size, patch_size, hidden_size, mlp_dim, num_layers,
                       num_heads, pos_embed, classification=False,
                       dropout_rate=dropout_rate, qkv_bias=qkv_bias, norm=vit_norm,
                       device=device, dtype=dtype)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, 3, 1, encoder_norm,
                                        res_block=res_block, **dd)

        def pr_up(cout, num_layer):
            return UnetrPrUpBlock(hidden_size, cout, num_layer, 3, 1, 2, encoder_norm,
                                  conv_block=conv_block, res_block=res_block, **dd)

        self.encoder2 = pr_up(fs * 2, 2)
        self.encoder3 = pr_up(fs * 4, 1)
        self.encoder4 = pr_up(fs * 8, 0)

        def up(cin, cout):
            return UnetrUpBlock(cin, cout, 3, 2, decoder_norm, res_block=res_block, **dd)

        self.decoder5 = up(hidden_size, fs * 8)
        self.decoder4 = up(fs * 8, fs * 4)
        self.decoder3 = up(fs * 4, fs * 2)
        self.decoder2 = up(fs * 2, fs)
        self.out = UnetOutBlock(fs, out_channels, spatial_dims=len(img_size), device=device,
                                dtype=dtype)

    def proj_feat(self, tokens):
        """`[B, L, hidden]` -> `[B, *feat_size, hidden]`, in its level's
        state under spatial partitioning (this rank's slab where the level
        is sharded)."""
        return spatial.settle(
            tokens.reshape(tokens.shape[0], *self.feat_size, self.hidden_size), False)

    def forward(self, x_in, modalities=None):
        """`x_in [B, *spatial, Cin]`, `modalities int[B]` -> logits
        `[B, *spatial, out_channels]`."""
        if self.needs_modalities and modalities is None:
            raise ValueError("Modalities must be passed to the forward step when a "
                             "norm is 'instance_cond'.")
        def block(module, *args):
            return recompute.call(module, *args, modalities, recompute=self.use_checkpoint)

        line = spatial.line_of(x_in)
        with spatial.suspended():
            x, hidden = self.vit(x_in if line is None else spatial.gather_d(x_in, line),
                                 modalities)
        q = self.num_layers // 4
        enc1 = block(self.encoder1, x_in)
        enc2 = self.encoder2(self.proj_feat(hidden[q]), modalities)
        enc3 = self.encoder3(self.proj_feat(hidden[2 * q]), modalities)
        enc4 = self.encoder4(self.proj_feat(hidden[3 * q]), modalities)
        dec3 = block(self.decoder5, self.proj_feat(x), enc4)
        dec2 = block(self.decoder4, dec3, enc3)
        dec1 = block(self.decoder3, dec2, enc2)
        out = block(self.decoder2, dec1, enc1)
        return self.out(out)
