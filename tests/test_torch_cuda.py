"""Card-only tests: each hand-written kernel against its plain version on
the same CUDA tensors.  Marked `cuda`; they skip where no card is present.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 results within 1e-5 relative to the output's scale
(summation order and FMA contraction differ); bf16 results within one
bf16 ulp of the largest output (both sides round the same f32 value once,
so a last-bit difference can flip the rounding).
"""

import numpy as np
import pytest
import torch

from miseg_tpu_torch.ops.kernels import fused_norm, window_attention as wa
from miseg_tpu_torch.ops.window import window_region_ids

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


def _tol(ref: torch.Tensor, dtype) -> float:
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return scale * 2.0 ** -7 + 1e-6 if dtype == torch.bfloat16 else 1e-5 * (1.0 + scale)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 48), (1, 48, 48, 48, 48),
                                   (1, 3, 3, 3, 3072), (3, 4, 4, 4, 100)])
@pytest.mark.parametrize("affine", ["none", "channel", "bank"])
def test_k1_k2_match_plain(dev, gen, shape, dtype, affine):
    b, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dev, dtype)
    add = torch.randn(shape, generator=gen).to(dev, dtype)
    gamma = beta = styles = None
    if affine == "channel":
        gamma, beta = torch.randn(c, generator=gen).to(dev), torch.randn(c, generator=gen).to(dev)
    elif affine == "bank":
        gamma = torch.randn((2, c), generator=gen).to(dev)
        beta = torch.randn((2, c), generator=gen).to(dev)
        styles = torch.tensor([5, -1, 1][:b], dtype=torch.int32, device=dev)  # clamps
    x3 = x.reshape(b, -1, c)
    scale, shift = fused_norm.channel_scale_shift(x3, gamma, beta, styles)
    rs, rh = fused_norm.channel_scale_shift_plain(x3, gamma, beta, styles)
    assert _err(scale, rs) <= 1e-5 * (1 + float(rs.abs().max()))
    assert _err(shift, rh) <= 1e-5 * (1 + float(rh.abs().max()))
    for a3, slope in [(None, None), (add.reshape(x3.shape), 0.01)]:
        y = fused_norm.apply_scale_shift(x3, rs, rh, a3, negative_slope=slope)
        ref = fused_norm.apply_scale_shift_plain(x3, rs, rh, a3, negative_slope=slope)
        assert y.dtype == dtype
        assert _err(y, ref) <= _tol(ref, dtype)
    torch.cuda.synchronize()


def test_k1_k2_count_launches(dev):
    x = torch.randn((1, 4, 4, 4, 8), device=dev)
    fused_norm.stats_launches = fused_norm.apply_launches = 0
    fused_norm.instance_norm_act(x)
    assert (fused_norm.stats_launches, fused_norm.apply_launches) == (1, 1)


# (window batch, N, channels, heads, mask geometry or None)
_ATTN = {
    "stage1_ids": (343, 343, 48, 3, ((49, 49, 49), (7, 7, 7), (3, 3, 3))),
    "stage2": (64, 343, 96, 6, None),
    "stage3_ids": (16, 343, 192, 12, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "stage4_clipped": (1, 216, 384, 24, None),
    "hd6_n27_ids": (16, 27, 12, 2, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd64_n8": (4, 8, 128, 2, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_ATTN))
def test_k5_matches_plain(dev, gen, case, dtype):
    bw, n, c, heads, geom = _ATTN[case]
    qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=gen).to(dev)
    ids = None if geom is None else window_region_ids(*geom, device=dev)
    before = wa.launches
    out = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
    assert wa.launches == before + 1
    ref = wa.window_attention_plain(q, k, v, bias, ids, num_heads=heads)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (bw, n, c)
    assert _err(out, ref) <= _tol(ref, dtype)


def test_k5_rejects_oversize(dev):
    q = torch.zeros((1, 344, 16), device=dev)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros((1, 344, 344), device=dev), num_heads=1)
    q = torch.zeros((1, 8, 65), device=dev)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros((1, 8, 8), device=dev), num_heads=1)


def test_model_forward_card_matches_cpu(dev):
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    cfg = Config(model_name="swin_unetr", out_channels=4, feature_size=[12],
                 num_heads=2, roi_x=32, roi_y=32, roi_z=32,
                 encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                 decoder_norm_name="instance")
    cpu = model_from_config(cfg, device="cpu")
    card = model_from_config(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 32, 1)).astype(np.float32))
    mods = torch.tensor([0, 1], dtype=torch.int32)
    with torch.no_grad():
        want = cpu(x, mods)
        got = card(x.to(dev), mods.to(dev)).cpu()
    assert _err(got, want) <= 1e-4 * (1 + float(want.abs().max()))
