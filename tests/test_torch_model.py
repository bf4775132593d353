"""The port's C-Swin-UNETR and its blocks against the JAX package on
bridged weights (CPU, f32).

Whole slice: swin_unetr, depths 2, 32^3 ROI, 4 classes, `instance_cond`
encoder/ViT and `instance` decoder norms, on both of the port's conv-block
paths (the fused conv chain and the unfused one), at two widths:
feature_size 12 with num_heads 2 at batch 2 (modalities [0, 1]), and the
flagship's feature_size 48 with heads 3/6/12/24 (head dim 16) at batch 1.
Logits must agree at atol 2e-4 (the tolerance covers f32
summation-order drift through ~60 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.nn import convolutions as JC
from miseg_tpu.nn.dynunet import UnetResBlock as JUnetResBlock
from miseg_tpu.nn.swin import PatchEmbed as JPatchEmbed
from miseg_tpu.nn.swin import PatchMergingV2 as JPatchMerging
from miseg_tpu.nn.unetr_blocks import UnetrUpBlock as JUnetrUpBlock
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.nn import convolutions as TC
from miseg_tpu_torch.nn.dynunet import UnetResBlock
from miseg_tpu_torch.nn.swin import PatchEmbed, PatchMergingV2
from miseg_tpu_torch.nn.unetr_blocks import UnetrUpBlock
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_MODEL = 2e-4
ATOL_BLOCK = 1e-5
COND = ("instance_cond", {"num_styles": 2, "affine": True})

_CFG = dict(model_name="swin_unetr", out_channels=4, feature_size=[12],
            num_heads=2, depth_swin_block=[2], roi_x=32, roi_y=32, roi_z=32,
            encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
            decoder_norm_name="instance")
# (feature_size, num_heads, batch): the fs-12 slice, and the flagship's width
_WIDTHS = {"fs12": (12, 2, 2), "fs48": (48, 3, 1)}


# the fs-12 cases keep their ids from before the width was a parameter
@pytest.mark.parametrize("width,fused_conv", [("fs12", True), ("fs12", False),
                                              ("fs48", True), ("fs48", False)],
                         ids=["True", "False", "fs48-True", "fs48-False"])
def test_swin_unetr_matches_jax(rng, width, fused_conv):
    fs, heads, batch = _WIDTHS[width]
    cfg = dict(_CFG, feature_size=[fs], num_heads=heads)
    x = rng.standard_normal((batch, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([0, 1][:batch], np.int32)
    jmodel = jax_model_from_config(JConfig(**cfg))
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    # jitted: eager flax apply of the whole model is ~5x slower on the CPU
    forward = jax.jit(lambda p, a, m: jmodel.apply({"params": p}, a, m))
    want = forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                   jnp.asarray(mods))

    state = state_dict_from_jax(params)
    assert len(state) == 203
    model = model_from_config(Config(**cfg), device="cpu", fused_conv=fused_conv)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model(t(x), t(mods))
    err = max_err(got, want)
    print(f"swin_unetr {width} 32^3 f32 fused_conv={fused_conv} logits "
          f"max |port - jax| = {err:.3e}")
    assert np.isfinite(got.numpy()).all()
    assert err <= ATOL_MODEL


def test_pre_swin_unetr_builds_swin_unetr():
    """`pre_swin_unetr` builds the same SwinUNETR as `swin_unetr`, as the
    JAX factory does (miseg_tpu/models/factory.py:77)."""
    pre = model_from_config(Config(**dict(_CFG, model_name="pre_swin_unetr")), device="cpu")
    plain = model_from_config(Config(**_CFG), device="cpu")
    assert type(pre) is type(plain)
    assert [(n, type(m)) for n, m in pre.named_modules()] == \
        [(n, type(m)) for n, m in plain.named_modules()]
    assert {k: v.shape for k, v in pre.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}


def _bridged(jmod, port, *args):
    params = seeded_params(jmod, *[jnp.asarray(a) for a in args])
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                      *[jnp.asarray(a) for a in args])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*[t(a) for a in args])
    return got, want


@pytest.mark.parametrize("legacy", [True, False])
def test_patch_merging_odd_dims(rng, legacy):
    """Odd dims pad before the 2^3 merge; `legacy` keeps the duplicated
    MONAI v0.9 slices."""
    x = rng.standard_normal((2, 5, 6, 7, 4)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    got, want = _bridged(JPatchMerging(dim=4, norm=COND, legacy=legacy),
                         PatchMergingV2(4, COND, legacy, device="cpu"), x, mods)
    assert max_err(got, want) <= ATOL_BLOCK


def test_patch_embed_pads_to_patch_multiple(rng):
    x = rng.standard_normal((1, 9, 10, 11, 1)).astype(np.float32)
    got, want = _bridged(JPatchEmbed(patch_size=(2, 2, 2), embed_dim=6),
                         PatchEmbed((2, 2, 2), 1, 6, device="cpu"), x)
    assert got.shape == (1, 5, 5, 6, 6)
    assert max_err(got, want) <= ATOL_BLOCK


@pytest.mark.parametrize("cin,stride", [(3, 1), (6, 1), (3, 2)])
def test_unet_res_block(rng, cin, stride):
    x = rng.standard_normal((2, 8, 8, 8, cin)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    got, want = _bridged(JUnetResBlock(out_channels=6, stride=stride, norm=COND),
                         UnetResBlock(cin, 6, 3, stride, COND, device="cpu"), x, mods)
    assert max_err(got, want) <= ATOL_BLOCK


def test_unetr_up_block_transposed_conv(rng):
    x = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    skip = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    jmod = JUnetrUpBlock(out_channels=4, norm="instance", res_block=True)
    port = UnetrUpBlock(8, 4, 3, 2, "instance", res_block=True, device="cpu")
    got, want = _bridged(jmod, port, x, skip)
    assert max_err(got, want) <= ATOL_BLOCK


def test_conv_padding_rules():
    for k, s in [(3, 1), (3, 2), (1, 1), (2, 2), ((3, 1, 3), (1, 1, 2))]:
        p = JC.get_padding(k, s)
        assert TC.get_padding(k, s) == p
        assert TC.get_output_padding(k, s, p) == JC.get_output_padding(k, s, p)
