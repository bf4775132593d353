"""Model factory: `Config` -> `nn.Module` (counterpart of
`miseg_tpu/models/factory.py`): all five of its models.  `unetr` builds
UNETR, `unet` the residual UNet, `unet_vanilla` UNetVanilla, and
`swin_unetr` and `pre_swin_unetr` the same SwinUNETR (`pre_swin_unetr`
starts from MONAI's Swin-ViT weights: `Trainer.fresh_state`).
`cfg.use_checkpoint` turns on the activation recompute of UNETR and
SwinUNETR."""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config, _scalar_or_list
from ..ops.init import init_linear
from ..ops.norms import parse_normalization
from ..utils.platform import resolve_device
from .swin_unetr import SwinUNETR
from .unet import UNet, UNetVanilla
from .unetr import UNETR

MODEL_NAMES = ("unetr", "unet", "unet_vanilla", "swin_unetr", "pre_swin_unetr")


def _norm_specs(cfg: Config):
    kw = dict(num_groups=cfg.num_groups, num_styles=cfg.num_styles)
    vit = parse_normalization(cfg.vit_norm_name, affine=not cfg.vit_norm_no_affine, **kw)
    enc = parse_normalization(cfg.encoder_norm_name,
                              affine=not cfg.encoder_norm_no_affine, **kw)
    dec = parse_normalization(cfg.decoder_norm_name,
                              affine=not cfg.decoder_norm_no_affine, **kw)
    return vit, enc, dec


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from `generator` in module
    order: a module's own `init_parameters` where it has one (unit norm
    scales, N(0, 0.02) truncated rel-pos and position tables and
    perceptron kernels, zero class tokens), else flax's defaults:
    lecun-normal kernels, zero biases."""
    for m in model.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)
        elif isinstance(m, nn.Linear):
            init_linear(m, generator)


def model_from_config(cfg: Config, *, device=None, dtype=torch.float32,
                      generator: torch.Generator | None = None,
                      fused_conv: bool = True) -> nn.Module:
    """Build and initialise `cfg`'s model (one of `MODEL_NAMES`) on
    `device` (the CUDA card unless given).  Weights come from `generator`,
    by default one seeded with `cfg.seed`; a state dict can then replace
    them.  `fused_conv` selects the conv blocks' path of UNETR and
    SwinUNETR (`nn/dynunet.py`); the state dict is the same on both.  The
    UNets have no such blocks and ignore it."""
    model = _build(cfg, resolve_device(device), dtype, fused_conv)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.eval()


def buffer_names(model: nn.Module | Config) -> set[str]:
    """The state dict entries of a model that are buffers, not parameters:
    batch norms' running statistics, f32 whatever the parameters' dtype.
    The trainer carries them in `TrainState.buffers`; `serve.save_bundle`
    leaves them uncast.  Of a `Config`, read from its model built on the
    meta device (nothing allocated or drawn)."""
    if isinstance(model, Config):
        model = _build(model, torch.device("meta"), torch.float32, True)
    kept = model.state_dict().keys()
    return {n for n, _ in model.named_buffers() if n in kept}


def _build(cfg: Config, device: torch.device, dtype, fused_conv: bool) -> nn.Module:
    """`cfg`'s model with its parameters uninitialised."""
    vit_norm, encoder_norm, decoder_norm = _norm_specs(cfg)
    if cfg.model_name not in MODEL_NAMES:
        raise ValueError(f"model {cfg.model_name!r} is not ported yet; "
                         f"the port builds {MODEL_NAMES}")
    if cfg.model_name == "unetr":
        model = UNETR(
            in_channels=cfg.in_channels, out_channels=cfg.out_channels, img_size=cfg.roi,
            feature_size=cfg.feature_size_scalar, hidden_size=cfg.hidden_size,
            mlp_dim=cfg.mlp_dim, num_heads=cfg.num_heads, pos_embed=cfg.pos_embed,
            conv_block=not cfg.no_conv_block, res_block=not cfg.no_res_block,
            dropout_rate=cfg.dropout_rate, qkv_bias=cfg.qkv_bias, vit_norm=vit_norm,
            decoder_norm=decoder_norm, encoder_norm=encoder_norm,
            use_checkpoint=cfg.use_checkpoint, fused_conv=fused_conv, device=device,
            dtype=dtype)
    elif cfg.model_name in ("unet", "unet_vanilla"):
        unet = dict(in_channels=cfg.in_channels, out_channels=cfg.out_channels,
                    strides=list(cfg.strides), kernel_size=_scalar_or_list(cfg.kernel_size),
                    up_kernel_size=_scalar_or_list(cfg.up_kernel_size),
                    num_res_units=cfg.num_res_units, act=cfg.activation,
                    norm_down=encoder_norm, norm_up=decoder_norm, dropout=cfg.dropout_rate,
                    bias=not cfg.no_bias, adn_ordering=cfg.adn_ordering,
                    spatial_dims=len(cfg.roi), device=device, dtype=dtype)
        if cfg.model_name == "unet":
            # the channels start at 2 * feature_size: the reference's TODO at
            # networks/nets/unet.py:218-219, kept for its checkpoints (W4)
            model = UNet(channels=[cfg.feature_size_scalar * 2 ** i
                                   for i in range(1, cfg.num_layers + 1)], **unet)
        else:
            model = UNetVanilla(channels=list(cfg.feature_size), **unet)
    else:
        if len(cfg.depth_swin_block) == 1:
            depths = (cfg.depth_swin_block[0],) * 4
        elif len(cfg.depth_swin_block) == 4:
            depths = tuple(cfg.depth_swin_block)
        else:
            raise ValueError("The length of depth_swin_block should be 4")
        num_heads = tuple(2 ** i * cfg.num_heads for i in range(4))
        model = SwinUNETR(
            img_size=cfg.roi, in_channels=cfg.in_channels,
            out_channels=cfg.out_channels, depths=depths, num_heads=num_heads,
            feature_size=cfg.feature_size_scalar, drop_rate=cfg.dropout_rate,
            attn_drop_rate=cfg.attn_drop_rate, dropout_path_rate=cfg.dropout_path_rate,
            normalize=not cfg.no_normalize_swin, downsample=cfg.downsample,
            vit_norm=vit_norm, encoder_norm=encoder_norm, decoder_norm=decoder_norm,
            use_checkpoint=cfg.use_checkpoint, fused_conv=fused_conv, device=device,
            dtype=dtype)
    return model
