"""Vision Transformer backbone with per-modality conditional norms
(counterpart of `miseg_tpu/models/vit.py:30-95`).

patch embedding -> `num_layers` x TransformerBlock (the hidden states
kept after every block) -> the final norm -> `(x, hidden_states)`; with
`classification`, a `cls_token` goes in front of the tokens and the head
(`GradientReversal` when asked, `classification_head`, Tanh or Softmax)
turns its final state into `(logits, hidden_states)`.  A `layer` norm
acts over the channels; the others take the L tokens as the spatial axis
(channel-last `[B, L, C]` is already the reference's `n c l` view).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..nn.layers import GradientReversal
from ..nn.norms import make_norm
from ..nn.patch_embedding import PatchEmbeddingBlock
from ..nn.transformer import TransformerBlock
from ..ops.init import fill_

NormSpec = tuple[str, dict[str, Any]] | str


class ViT(nn.Module):
    def __init__(self, in_channels: int, img_size: Sequence[int],
                 patch_size: Sequence[int], hidden_size: int = 768, mlp_dim: int = 3072,
                 num_layers: int = 12, num_heads: int = 12, pos_embed: str = "conv",
                 classification: bool = False, num_classes: int = 2,
                 dropout_rate: float = 0.0, post_activation: str = "Tanh",
                 qkv_bias: bool = False, norm: NormSpec = ("layer", {}),
                 classification_reverse_gradient: bool = False,
                 alpha_reversal: float = 1.0, *, device=None, dtype=None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads:
            raise ValueError("hidden_size should be divisible by num_heads.")
        dd = dict(device=device, dtype=dtype)
        self.norm_kind = norm if isinstance(norm, str) else norm[0]
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.classification, self.post_activation = classification, post_activation
        self.patch_embedding = PatchEmbeddingBlock(
            in_channels, img_size, patch_size, hidden_size, num_heads, pos_embed,
            dropout_rate=dropout_rate, **dd)
        if classification:
            self.cls_token = nn.Parameter(torch.empty((1, 1, hidden_size), **dd))
        for i in range(num_layers):
            self.add_module(f"blocks_{i}", TransformerBlock(
                hidden_size, mlp_dim, num_heads, dropout_rate, qkv_bias, norm, **dd))
        self.norm = make_norm(norm, hidden_size, **dd)
        if classification:
            self.reverse = (GradientReversal(alpha_reversal)
                            if classification_reverse_gradient else None)
            self.classification_head = skip_init(nn.Linear, hidden_size, num_classes, **dd)

    def init_parameters(self, generator=None) -> None:
        if self.classification:
            fill_(self.cls_token, torch.zeros(self.cls_token.shape))

    def forward(self, x, modalities=None):
        """`x [B, *spatial, Cin]` -> (`[B, L, hidden]` after the final norm,
        or the head's `[B, num_classes]`; the `num_layers` hidden states)."""
        if self.norm_kind == "instance_cond" and modalities is None:
            raise ValueError("Modalities must be passed to the forward step when "
                             "norm is 'instance_cond'.")
        x = self.patch_embedding(x)
        if self.classification:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, self.hidden_size)
            x = torch.cat([cls, x], dim=1)
        hidden_states = []
        for i in range(self.num_layers):
            x = getattr(self, f"blocks_{i}")(x, modalities)
            hidden_states.append(x)
        x = self.norm(x, modalities)
        if not self.classification:
            return x, hidden_states
        h = x[:, 0]
        if self.reverse is not None:
            h = self.reverse(h)
        h = self.classification_head(h)
        if self.post_activation == "Tanh":
            h = torch.tanh(h)
        elif self.post_activation == "Softmax":
            h = h.softmax(dim=1)
        return h, hidden_states
