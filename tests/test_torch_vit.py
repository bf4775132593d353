"""The port's ViT parts against the JAX package on bridged weights (CPU,
f32): `SABlock`, `TransformerBlock` (layer and instance_cond norms),
`PatchEmbeddingBlock` (conv and perceptron patchify, each position
embedding), `UnetrPrUpBlock` (0-2 layers, with and without conv blocks,
residual or basic), the `ViT` with and without its classification head,
and `GradientReversal`'s gradient.  Blocks agree at atol 1e-5, the ViT's
outputs at 1e-5 relative to their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.models.vit import ViT as JViT
from miseg_tpu.nn.layers import gradient_reversal as j_gradient_reversal
from miseg_tpu.nn.patch_embedding import PatchEmbeddingBlock as JPatchEmbeddingBlock
from miseg_tpu.nn.patch_embedding import build_sincos_position_embedding as j_sincos
from miseg_tpu.nn.transformer import SABlock as JSABlock
from miseg_tpu.nn.transformer import TransformerBlock as JTransformerBlock
from miseg_tpu.nn.unetr_blocks import UnetrPrUpBlock as JUnetrPrUpBlock
from miseg_tpu_torch.models.vit import ViT
from miseg_tpu_torch.nn.layers import gradient_reversal
from miseg_tpu_torch.nn.patch_embedding import PatchEmbeddingBlock, build_sincos_position_embedding
from miseg_tpu_torch.nn.transformer import SABlock, TransformerBlock
from miseg_tpu_torch.nn.unetr_blocks import UnetrPrUpBlock
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL = 1e-5
COND = ("instance_cond", {"num_styles": 2, "affine": True})
LAYER = ("layer", {"elementwise_affine": True})


def _bridged(jmod, port, *args):
    """(port output, JAX output) on the same seeded params and inputs."""
    params = seeded_params(jmod, *[jnp.asarray(a) for a in args])
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                      *[jnp.asarray(a) for a in args])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*[t(a) for a in args])
    return got, want


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_sablock_matches_jax(rng, qkv_bias):
    x = rng.standard_normal((2, 27, 48)).astype(np.float32)
    got, want = _bridged(JSABlock(num_heads=6, qkv_bias=qkv_bias),
                         SABlock(48, 6, qkv_bias=qkv_bias, device="cpu"), x)
    assert max_err(got, want) <= ATOL


def test_sablock_rounds_p_to_v_dtype(rng):
    """bf16 attention: the f32 probabilities are rounded to bf16 before
    P·V, as the JAX einsum does; the f32 softmax of the same bf16 scores
    taken without that rounding is further away."""
    blk = SABlock(32, 4, device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32))
    with torch.no_grad():
        blk.qkv.weight.copy_(torch.from_numpy(rng.standard_normal((96, 32)) / 4))
        blk.proj.weight.copy_(torch.eye(32))
        blk.proj.bias.zero_()
        xb = x.to(torch.bfloat16)
        got = blk.to(torch.bfloat16)(xb).float()
        q, k, v = blk.qkv(xb).reshape(1, 64, 3, 4, 8).permute(2, 0, 3, 1, 4)
        p = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * 8 ** -0.5).softmax(-1)
        rounded = torch.matmul(p.to(torch.bfloat16), v).transpose(1, 2).reshape(1, 64, 32)
        unrounded = torch.matmul(p, v.float()).transpose(1, 2).reshape(1, 64, 32)
    assert torch.equal(got, rounded.float())
    assert not torch.equal(got, unrounded.to(torch.bfloat16).float())


@pytest.mark.parametrize("norm", ["layer", "instance_cond"])
def test_transformer_block_matches_jax(rng, norm):
    spec = LAYER if norm == "layer" else COND
    x = rng.standard_normal((2, 27, 48)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    got, want = _bridged(
        JTransformerBlock(hidden_size=48, mlp_dim=96, num_heads=4, norm=spec),
        TransformerBlock(48, 96, 4, norm=spec, device="cpu"), x, mods)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("pos_embed", ["conv", "perceptron"])
@pytest.mark.parametrize("pos_embed_type", ["learnable", "sincos", "none"])
def test_patch_embedding_matches_jax(rng, pos_embed, pos_embed_type):
    x = rng.standard_normal((2, 8, 12, 16, 3)).astype(np.float32)
    kw = dict(img_size=(8, 12, 16), patch_size=(4, 4, 8), hidden_size=24, num_heads=4,
              pos_embed=pos_embed, pos_embed_type=pos_embed_type)
    port = PatchEmbeddingBlock(3, **kw, device="cpu")
    got, want = _bridged(JPatchEmbeddingBlock(**kw), port, x)
    assert got.shape == (2, 12, 24)
    assert max_err(got, want) <= ATOL
    # the sine-cosine table is a buffer, left out of the state dict
    assert ("position_embeddings" in port.state_dict()) == (pos_embed_type == "learnable")
    assert all("sincos" not in k for k in port.state_dict())


def test_perceptron_flattens_in_jax_order(rng):
    """The perceptron's patch vector is `(p0, p1, p2, C)`: the same bridged
    Linear over a `(C, p0, p1, p2)` flatten of the same patches is far off
    (the patches are random, so no order but the right one matches)."""
    x = rng.standard_normal((1, 8, 8, 8, 2)).astype(np.float32)
    kw = dict(img_size=(8, 8, 8), patch_size=(4, 4, 4), hidden_size=16, num_heads=2,
              pos_embed="perceptron", pos_embed_type="none")
    port = PatchEmbeddingBlock(2, **kw, device="cpu")
    got, want = _bridged(JPatchEmbeddingBlock(**kw), port, x)
    assert max_err(got, want) <= ATOL
    patches = t(x).reshape(1, 2, 4, 2, 4, 2, 4, 2).permute(0, 1, 3, 5, 7, 2, 4, 6)
    with torch.no_grad():
        wrong = port.patch_embeddings(patches.reshape(1, 8, 128))
    assert max_err(wrong, want) > 0.1


def test_sincos_table_is_jax_table():
    for grid, dim in (((6, 6, 6), 768), ((2, 3, 4), 24)):
        assert np.array_equal(build_sincos_position_embedding(grid, dim), j_sincos(grid, dim))
    with pytest.raises(ValueError, match="divisible by 6"):
        build_sincos_position_embedding((2, 2, 2), 20)


@pytest.mark.parametrize("num_layer", [0, 1, 2])
@pytest.mark.parametrize("conv_block", [True, False])
@pytest.mark.parametrize("res_block", [True, False])
def test_unetr_pr_up_block_matches_jax(rng, num_layer, conv_block, res_block):
    x = rng.standard_normal((2, 2, 2, 2, 24)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jmod = JUnetrPrUpBlock(out_channels=8, num_layer=num_layer, norm=COND,
                           conv_block=conv_block, res_block=res_block)
    port = UnetrPrUpBlock(24, 8, num_layer, 3, 1, 2, COND, conv_block=conv_block,
                          res_block=res_block, device="cpu")
    got, want = _bridged(jmod, port, x, mods)
    assert got.shape == (2,) + (2 ** (num_layer + 2),) * 3 + (8,)
    assert max_err(got, want) <= ATOL


_VIT = dict(in_channels=1, img_size=(32, 32, 32), patch_size=(16, 16, 16), hidden_size=32,
            mlp_dim=64, num_layers=4, num_heads=4, pos_embed="perceptron", norm=COND)


@pytest.mark.parametrize("head", [None, "Tanh", "Softmax-reversed"])
def test_vit_matches_jax(rng, head):
    """Final output (or the head's) and every hidden state."""
    kw = dict(_VIT)
    if head is not None:
        kw.update(classification=True, num_classes=3, post_activation=head.split("-")[0],
                  classification_reverse_gradient=head.endswith("reversed"),
                  alpha_reversal=0.5)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    jmod = JViT(**kw)
    params = seeded_params(jmod, jnp.asarray(x), jnp.asarray(mods))
    want, want_hidden = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                                   jnp.asarray(x), jnp.asarray(mods))
    port = ViT(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got, hidden = port(t(x), t(mods))
    assert got.shape == want.shape == ((2, 3) if head else (2, 8, 32))
    assert len(hidden) == len(want_hidden) == 4
    # f32 summation-order drift grows with the residual stream's scale
    # (|hidden| ~ 10 after 4 blocks): 1e-5 relative to it
    scale = max(float(np.abs(np.asarray(w)).max()) for w in [want, *want_hidden])
    print(f"ViT head={head}: |output| {max_err(got, want):.2e}, hidden "
          f"{max(max_err(h, w) for h, w in zip(hidden, want_hidden)):.2e}, scale {scale:.1f}")
    assert max_err(got, want) <= ATOL * (1 + scale)
    assert max(max_err(h, w) for h, w in zip(hidden, want_hidden)) <= ATOL * (1 + scale)


def test_gradient_reversal_gradient(rng):
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    want = jax.grad(lambda a: (j_gradient_reversal(a, 0.7) * w).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = gradient_reversal(xt, 0.7)
    assert torch.equal(out, t(x))
    (out * t(w)).sum().backward()
    assert max_err(xt.grad, want) <= 1e-7
    assert max_err(xt.grad, -0.7 * w) <= 1e-7
