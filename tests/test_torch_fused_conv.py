"""The port's fused conv chain against the JAX package on the CPU: K4's
plain version against the Pallas `conv3_norm_stats` (interpret mode) plus
`norm_columns`, K3's against `apply_norm2_act`, the fused blocks against
JAX's fused blocks (`MISEG_PALLAS_CONV=1`) on bridged weights, and the
port's fused path against its unfused path.

Tolerances (f32): y within 1e-5 * (1 + max|y|) (summation order); norm
columns within 1e-4 relative (JAX folds a one-pass variance, the port a
two-pass one); blocks within 5e-5, as tests/test_fused_blocks.py; the
fs-12 model within 2e-4, as tests/test_torch_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.nn.dynunet import UnetBasicBlock as JUnetBasicBlock
from miseg_tpu.nn.dynunet import UnetResBlock as JUnetResBlock
from miseg_tpu.nn.unetr_blocks import UnetrUpBlock as JUnetrUpBlock
from miseg_tpu.ops import dispatch
from miseg_tpu.ops.pallas import fused_conv as jfc
from miseg_tpu.ops.pallas import fused_norm as jfn
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.models.factory import init_weights
from miseg_tpu_torch.nn import dynunet
from miseg_tpu_torch.nn.dynunet import UnetBasicBlock, UnetResBlock
from miseg_tpu_torch.nn.unetr_blocks import UnetrUpBlock
from miseg_tpu_torch.ops.kernels import fused_conv, fused_norm
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
COND = ("instance_cond", {"num_styles": 2, "affine": True})
ATOL_BLOCK = 5e-5
ATOL_MODEL = 2e-4
_CFG = dict(model_name="swin_unetr", out_channels=4, feature_size=[12],
            num_heads=2, depth_swin_block=[2], roi_x=32, roi_y=32, roi_z=32,
            encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
            decoder_norm_name="instance")


@pytest.fixture
def jax_conv_chain(monkeypatch):
    """The JAX package's fused conv chain on (Pallas in interpret mode),
    its other Pallas kernels off, as tests/test_fused_blocks.py."""
    monkeypatch.setenv("MISEG_PALLAS_CONV", "1")
    monkeypatch.setenv("MISEG_PALLAS_NORM", "0")
    monkeypatch.setenv("MISEG_PALLAS_ATTN", "0")
    dispatch.clear_cache()
    yield
    monkeypatch.undo()
    dispatch.clear_cache()


def _opt(a):
    return None if a is None else t(a)


def _rel(a, b) -> float:
    return max_err(a, b) / (1.0 + float(np.abs(np.asarray(b)).max()))


# ---------------------------------------------------------------- K4 ------

@pytest.mark.parametrize("prologue", ["none", "affine", "affine_leaky"])
@pytest.mark.parametrize("shape,cout", [((2, 6, 8, 8, 5), 7), ((2, 8, 8, 8, 1), 6),
                                        ((2, 2, 6, 5, 4), 8),
                                        # the card's coarse tiles: 4x4x4 bricks,
                                        # a whole 6^3 sample, a whole 3^3 one
                                        ((1, 8, 8, 8, 16), 16), ((1, 6, 6, 6, 32), 16),
                                        ((2, 3, 3, 3, 32), 32),
                                        # the search space's widths (fs 12/24/36),
                                        # which the card pads to 16: one brick at
                                        # 12->12, 36->36 and Cin = 1, 4x4x4 boxes
                                        # at the decoder's 24->12 and 48->24, a
                                        # whole 3^3 sample at 72->72
                                        ((1, 4, 4, 16, 12), 12), ((1, 4, 4, 8, 24), 12),
                                        ((1, 4, 4, 4, 48), 24), ((1, 4, 4, 16, 36), 36),
                                        ((1, 3, 3, 3, 72), 72), ((1, 4, 4, 16, 1), 12)])
def test_k4_plain_matches_jax(rng, shape, cout, prologue):
    b, cin = shape[0], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = shift = slope = None
    if prologue != "none":
        scale = (1.0 + 0.3 * rng.standard_normal((b, cin))).astype(np.float32)
        shift = (0.3 * rng.standard_normal((b, cin))).astype(np.float32)
    if prologue == "affine_leaky":
        slope = 0.01
    y_j, stats = jfc.conv3_norm_stats(
        jnp.asarray(x), jnp.asarray(w), None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift), slope=slope, interpret=True)
    w_port = t(w.transpose(4, 3, 0, 1, 2).copy())   # [O, I, 3, 3, 3]
    n = int(np.prod(shape[1:-1]))
    gammas = [(None, None, None),
              ((1 + 0.2 * rng.standard_normal(cout)).astype(np.float32),
               (0.2 * rng.standard_normal(cout)).astype(np.float32), None)]
    bank_g = (1 + 0.2 * rng.standard_normal((2, cout))).astype(np.float32)
    bank_b = (0.2 * rng.standard_normal((2, cout))).astype(np.float32)
    gammas += [(bank_g, bank_b, np.array([0, 1], np.int32)),
               (bank_g, bank_b, np.array([1, 7], np.int32))]  # 7 clamps to bank 1
    for gamma, beta, styles in gammas:
        y, sc, sh = fused_conv.conv3_norm_columns_plain(
            t(x), w_port, _opt(scale), _opt(shift), slope=slope, gamma=_opt(gamma),
            beta=_opt(beta), styles=_opt(styles))
        assert y.shape == (*shape[:-1], cout)
        assert max_err(y, y_j) <= 1e-5 * (1 + float(np.abs(np.asarray(y_j)).max()))
        sc_j, sh_j = jfc.norm_columns(
            stats, n, None if gamma is None else jnp.asarray(gamma),
            None if beta is None else jnp.asarray(beta),
            None if styles is None else jnp.asarray(styles))
        assert _rel(sc, sc_j) <= 1e-4 and _rel(sh, sh_j) <= 1e-4


def test_k4_wrapper_routes_cpu_tensors_to_plain(rng):
    x = t(rng.standard_normal((1, 4, 5, 6, 3)).astype(np.float32))
    w = t(rng.standard_normal((4, 3, 3, 3, 3)).astype(np.float32))
    sc = t(rng.standard_normal((1, 3)).astype(np.float32))
    sh = t(rng.standard_normal((1, 3)).astype(np.float32))
    before = fused_conv.launches
    got = fused_conv.conv3_norm_columns(x, w, sc, sh, slope=0.1)
    want = fused_conv.conv3_norm_columns_plain(x, w, sc, sh, slope=0.1)
    assert fused_conv.launches == before  # the plain version launches nothing
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["weights", "scale_only", "scale_shape", "bank_no_styles",
                                 "gamma_width", "beta_missing", "styles_length"])
def test_k4_wrapper_rejects_bad_operands(bad):
    x = torch.zeros((2, 4, 4, 4, 3))
    w = torch.zeros((5, 3, 3, 3, 3))
    bank = dict(gamma=torch.ones((2, 5)), beta=torch.zeros((2, 5)))
    kw = {
        "weights": {},
        "scale_only": dict(scale=torch.ones((2, 3))),
        "scale_shape": dict(scale=torch.ones((2, 5)), shift=torch.ones((2, 5))),
        "bank_no_styles": bank,
        "gamma_width": dict(gamma=torch.ones(4), beta=torch.zeros(4)),
        "beta_missing": dict(gamma=torch.ones(5)),
        "styles_length": dict(bank, styles=torch.zeros(3, dtype=torch.int32)),
    }[bad]
    if bad == "weights":
        w = torch.zeros((5, 3, 3, 3, 1))
    with pytest.raises(ValueError):
        fused_conv.conv3_norm_columns(x, w, **kw)


def test_k4_supported_matches_jax_geometry():
    cases = [((1, 8, 8, 8, 4), 3, 1), ((1, 8, 8, 4), 3, 1), ((1, 8, 8, 8, 4), 3, 2),
             ((1, 8, 8, 8, 4), (3, 3, 1), 1), ((1, 2, 2, 2, 768), 3, 1),
             ((1, 1, 8, 8, 4), 3, 1), ((1, 8, 8, 8, 4), (3, 3, 3), (1, 1, 1))]
    for shape, k, s in cases:
        assert fused_conv.supported(shape, k, s) == jfc.supported(shape, k, s), (shape, k, s)


def test_k4_kernel_weights_cached_on_version():
    w = torch.nn.Parameter(torch.randn((4, 3, 3, 3, 3)))
    packed = fused_conv.kernel_weights(w, torch.float32)
    assert torch.equal(packed, w.detach().permute(2, 3, 4, 1, 0))
    assert packed.is_contiguous()
    assert fused_conv.kernel_weights(w, torch.float32) is packed
    bf = fused_conv.kernel_weights(w, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    with torch.no_grad():
        w.mul_(2.0)   # an in-place update (load_state_dict) bumps the version
    again = fused_conv.kernel_weights(w, torch.float32)
    assert torch.equal(again, 2.0 * packed)


def test_k4_kernel_weights_padded_widths():
    """The tensor-core paths' padded copy `[3, 3, 3, I', O']` is the unpadded
    one with zero rows and columns appended; the cache holds one copy,
    keyed on (version, dtype, widths): the same key returns it, another
    widths or an update rebuilds it."""
    w = torch.nn.Parameter(torch.randn((12, 36, 3, 3, 3)))
    plain = fused_conv.kernel_weights(w, torch.bfloat16)
    padded = fused_conv.kernel_weights(w, torch.bfloat16, (48, 16))
    assert padded.shape == (3, 3, 3, 48, 16) and padded.is_contiguous()
    assert torch.equal(padded[..., :36, :12], plain)
    assert not padded[..., 36:, :].any() and not padded[..., :, 12:].any()
    assert fused_conv.kernel_weights(w, torch.bfloat16, (48, 16)) is padded
    assert w._miseg_k4_weights[0][2:] == (torch.bfloat16, (48, 16))
    assert fused_conv.kernel_weights(w, torch.bfloat16, (36, 12)) is not padded
    assert torch.equal(fused_conv.kernel_weights(w, torch.bfloat16, (36, 12)), plain)
    assert w._miseg_k4_weights[0][2:] == (torch.bfloat16, (36, 12))
    before = fused_conv.kernel_weights(w, torch.bfloat16, (48, 16))
    with torch.no_grad():
        w.mul_(2.0)
    after = fused_conv.kernel_weights(w, torch.bfloat16, (48, 16))
    assert after is not before
    assert torch.equal(after[..., :36, :12], w.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0))
    assert not after[..., 36:, :].any() and not after[..., :, 12:].any()
    with torch.inference_mode():   # no version counter: packed per call, not cached
        wi = torch.randn((4, 8, 3, 3, 3))
        got = fused_conv.kernel_weights(wi, torch.float32, (16, 16))
        assert torch.equal(got[..., :8, :4], wi.permute(2, 3, 4, 1, 0))
        assert not got[..., 8:, :].any() and not got[..., :, 4:].any()


# ---------------------------------------------------------------- K3 ------

@pytest.mark.parametrize("slope", [None, 0.01])
def test_k3_plain_matches_jax(rng, slope):
    shape = (2, 8, 8, 8, 16)
    x, res = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    sx, hx, sr, hr = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(4))
    want = jfn.apply_norm2_act(*(jnp.asarray(a) for a in (x, sx, hx, res, sr, hr)),
                               negative_slope=slope, interpret=True)
    got = fused_norm.apply_norm2_act(*(t(a) for a in (x, sx, hx, res, sr, hr)),
                                     negative_slope=slope)
    assert got.dtype == torch.float32
    assert max_err(got, want) <= 1e-5 * (1 + float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("slope", [None, 0.01])
def test_apply_norm_act_matches_jax(rng, slope):
    shape = (2, 8, 8, 8, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    sx, hx = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))
    want = jfn.apply_norm_act(jnp.asarray(x), jnp.asarray(sx), jnp.asarray(hx),
                              negative_slope=slope, interpret=True)
    got = fused_norm.apply_norm_act(t(x), t(sx), t(hx), negative_slope=slope)
    assert max_err(got, want) <= 1e-5 * (1 + float(np.abs(np.asarray(want)).max()))


def test_k3_rejects_mismatched_operands():
    x = torch.zeros((2, 4, 4, 4, 8))
    cols = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        fused_norm.apply_norm2_act(x, cols, cols, torch.zeros((2, 4, 4, 4, 4)), cols, cols)
    with pytest.raises(ValueError):
        fused_norm.apply_norm2_act(x, cols, cols, x, torch.zeros((1, 8)), cols)


# ------------------------------------------------------- fused blocks -----

def _count_chain(monkeypatch):
    """Counts of the JAX package's K4 calls and the port's K4 wrapper calls."""
    counts = {"jax": 0, "port": 0}
    jax_k4, port_k4 = jfc.conv3_norm_stats, fused_conv.conv3_norm_columns

    def jax_spy(*a, **k):
        counts["jax"] += 1
        return jax_k4(*a, **k)

    def port_spy(*a, **k):
        counts["port"] += 1
        return port_k4(*a, **k)

    monkeypatch.setattr(jfc, "conv3_norm_stats", jax_spy)
    monkeypatch.setattr(fused_conv, "conv3_norm_columns", port_spy)
    return counts


_BLOCKS = {
    "res_projected_cond": lambda: (JUnetResBlock(out_channels=8, norm=COND),
                                   UnetResBlock(4, 8, 3, 1, COND, device="cpu"),
                                   [(2, 8, 8, 8, 4)], True),
    "res_identity_instance": lambda: (JUnetResBlock(out_channels=8, norm="instance"),
                                      UnetResBlock(8, 8, 3, 1, "instance", device="cpu"),
                                      [(2, 8, 8, 8, 8)], False),
    "basic_cond": lambda: (JUnetBasicBlock(out_channels=8, norm=COND),
                           UnetBasicBlock(4, 8, 3, 1, COND, device="cpu"),
                           [(2, 8, 8, 8, 4)], True),
    "up_res_block": lambda: (JUnetrUpBlock(out_channels=4, norm="instance", res_block=True),
                             UnetrUpBlock(8, 4, 3, 2, "instance", res_block=True,
                                          device="cpu"),
                             [(2, 4, 4, 4, 8), (2, 8, 8, 8, 4)], False),
}


@pytest.mark.parametrize("case", sorted(_BLOCKS))
def test_fused_block_matches_jax_fused(jax_conv_chain, monkeypatch, rng, case):
    jmod, port, shapes, with_mods = _BLOCKS[case]()
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if with_mods:
        args.append(np.array([0, 1], np.int32))
    params = seeded_params(jmod, *[jnp.asarray(a) for a in args])
    counts = _count_chain(monkeypatch)
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                      *[jnp.asarray(a) for a in args])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*[t(a) for a in args])
    assert counts == {"jax": 2, "port": 2}   # both sides ran the fused chain
    assert max_err(got, want) <= ATOL_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_tail_is_k2_add(jax_conv_chain, monkeypatch, rng, dtype):
    """An identity-residual UnetResBlock ends in K2's add mode: its output
    is the K3 tail with ones/zeros columns, as JAX runs it (`x * 1 + 0 ==
    x` in f32), bit for bit, and matches JAX's fused block: f32 at
    ATOL_BLOCK; bf16 within two bf16 ulps of the largest output (an ulp is
    at most 2^-7 of it), since the two convs round y1 and y2 to bf16 after
    sums taken in another order (one ulp seen)."""
    jmod, port, shapes, _ = _BLOCKS["res_identity_instance"]()
    x = rng.standard_normal(shapes[0]).astype(np.float32)
    params = seeded_params(jmod, jnp.asarray(x))
    counts = _count_chain(monkeypatch)
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                      jnp.asarray(x).astype(dtype))
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.to(getattr(torch, dtype))
    xt = t(x).to(getattr(torch, dtype))
    with torch.no_grad():
        got = port(xt)
        y2, sc2, sh2 = dynunet._fused_convs(port, xt, None)
    tail = fused_norm.apply_norm2_act_plain(y2, sc2, sh2, xt, torch.ones_like(sc2),
                                            torch.zeros_like(sh2), negative_slope=port.slope)
    assert counts == {"jax": 2, "port": 4}   # the block's chain, then the convs again
    assert got.dtype == xt.dtype and torch.equal(got, tail)
    want = np.asarray(want, np.float32)
    tol = ATOL_BLOCK if dtype == "float32" else 2 * 2.0 ** -7 * float(np.abs(want).max())
    assert max_err(got.float(), want) <= tol


def test_fuse_plan_rejections(rng, monkeypatch):
    counts = _count_chain(monkeypatch)
    x = t(rng.standard_normal((1, 8, 8, 8, 4)).astype(np.float32))
    mods = torch.tensor([1], dtype=torch.int32)

    def both(make, *args):
        fused, plain = make(True), make(False)
        init_weights(fused, torch.Generator().manual_seed(0))
        plain.load_state_dict(fused.state_dict())
        with torch.no_grad():
            return fused(*args), plain(*args)

    got, want = both(lambda f: UnetResBlock(4, 8, 3, 2, "instance", fused_conv=f,
                                            device="cpu"), x)
    assert got.shape == (1, 4, 4, 4, 8) and torch.equal(got, want)       # stride 2
    got, want = both(lambda f: UnetResBlock(4, 8, 3, 1, "instance", act="relu",
                                            fused_conv=f, device="cpu"), x)
    assert torch.equal(got, want)                                         # not leaky
    got, want = both(lambda f: UnetResBlock(4, 8, 3, 1, ("instance", {"affine": False}),
                                            fused_conv=f, device="cpu"), x)
    assert torch.equal(got, want)                                         # no affine
    assert counts["port"] == 0
    blk = UnetResBlock(4, 8, 3, 1, COND, device="cpu")
    assert dynunet._fuse_plan(blk, torch.zeros((1, 8, 8, 4)), mods) is None   # 2-D
    assert dynunet._fuse_plan(blk, x, None) is None          # missing modalities
    with pytest.raises(ValueError, match="modalities"):
        blk(x, None)                # ...so the unfused path's norm asks for them
    assert dynunet._fuse_plan(blk, t(np.zeros((1, 1, 8, 8, 4), np.float32)), mods) is None
    assert dynunet._fuse_plan(blk, x, mods) == (mods,)
    assert counts["port"] == 0


# ------------------------------------------------------------ model -------

def test_fused_model_matches_unfused(rng):
    cfg = Config(**_CFG)
    fused = model_from_config(cfg, device="cpu")
    plain = model_from_config(cfg, device="cpu", fused_conv=False)
    assert list(fused.state_dict()) == list(plain.state_dict())
    plain.load_state_dict(fused.state_dict(), strict=True)
    x = t(rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32))
    mods = torch.tensor([0, 1], dtype=torch.int32)
    with torch.no_grad():
        got, want = fused(x, mods), plain(x, mods)
    assert max_err(got, want) <= 1e-5 * (1 + float(want.abs().max()))


def test_fused_model_matches_jax_fused_chain(jax_conv_chain, monkeypatch, rng):
    """The port's fused model against the JAX model applied (jitted) with
    its fused conv chain.  Parameters come from the flag-off shapes (the
    trees are the same either way, tests/test_fused_blocks.py), since
    flax init with the chain on is slow on the CPU."""
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jmodel = jax_model_from_config(JConfig(**_CFG))
    monkeypatch.setenv("MISEG_PALLAS_CONV", "0")
    dispatch.clear_cache()
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    monkeypatch.setenv("MISEG_PALLAS_CONV", "1")
    dispatch.clear_cache()
    counts = _count_chain(monkeypatch)
    forward = jax.jit(lambda p, a, m: jmodel.apply({"params": p}, a, m))
    want = forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(mods))
    model = model_from_config(Config(**_CFG), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(t(x), t(mods))
    # fs 12 at 32^3: every UnetResBlock but encoder10 (1^3) takes the chain
    assert counts == {"jax": 18, "port": 18}
    err = max_err(got, want)
    print(f"fused swin_unetr fs12 32^3 f32 logits max |port - jax fused| = {err:.3e}")
    assert err <= ATOL_MODEL
