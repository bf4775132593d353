"""Port K1 + K2 (plain versions, CPU) against the JAX package's norms:
the two-pass `ops/norms.py` reference (atol 1e-5, f32) and the Pallas
`fused_instance_norm_act` in interpret mode (atol 2e-5, as
tests/test_pallas.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, t

from miseg_tpu.ops import norms as JN
from miseg_tpu.ops.pallas import fused_instance_norm_act
from miseg_tpu_torch.ops import norms as TN
from miseg_tpu_torch.ops.kernels import fused_norm

torch.set_num_threads(1)
ATOL_TWO_PASS = 1e-5
ATOL_PALLAS = 2e-5


def _case(rng, shape, affine):
    x = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    styles = np.array([0, 1] * (shape[0] // 2) + [0] * (shape[0] % 2), np.int32)
    gamma = beta = None
    if affine == "channel":
        gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
        beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    elif affine == "bank":
        gamma = (1.0 + 0.3 * rng.standard_normal((2, c))).astype(np.float32)
        beta = (0.3 * rng.standard_normal((2, c))).astype(np.float32)
    return x, styles, gamma, beta


def _jax_two_pass(x, styles, gamma, beta):
    if gamma is not None and gamma.ndim == 2:
        return np.asarray(JN.conditional_instance_norm(
            jnp.asarray(x), jnp.asarray(styles), jnp.asarray(gamma), jnp.asarray(beta)))
    g = None if gamma is None else jnp.asarray(gamma)
    b = None if beta is None else jnp.asarray(beta)
    return np.asarray(JN.instance_norm(jnp.asarray(x), g, b))


def _port(x, styles, gamma, beta, **kw):
    return fused_norm.instance_norm_act(
        t(x), None if gamma is None else t(gamma), None if beta is None else t(beta),
        t(styles), **kw)


@pytest.mark.parametrize("affine", ["none", "channel", "bank"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (2, 3, 3, 3, 256)])
def test_plain_k1k2_matches_two_pass(rng, shape, affine):
    x, styles, gamma, beta = _case(rng, shape, affine)
    err = max_err(_port(x, styles, gamma, beta), _jax_two_pass(x, styles, gamma, beta))
    assert err <= ATOL_TWO_PASS, err


@pytest.mark.parametrize("slope", [None, 0.01])
@pytest.mark.parametrize("with_add", [False, True])
def test_plain_k1k2_add_and_slope(rng, slope, with_add):
    x, styles, gamma, beta = _case(rng, (2, 8, 8, 8, 16), "bank")
    add = rng.standard_normal(x.shape).astype(np.float32) if with_add else None
    want = _jax_two_pass(x, styles, gamma, beta)
    if with_add:
        want = want + add
    if slope is not None:
        want = np.where(want >= 0, want, slope * want)
    got = _port(x, styles, gamma, beta, negative_slope=slope,
                add=None if add is None else t(add))
    assert max_err(got, want) <= ATOL_TWO_PASS

    pallas = fused_instance_norm_act(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(styles),
        negative_slope=slope, add=None if add is None else jnp.asarray(add),
        interpret=True)
    assert max_err(got, pallas) <= ATOL_PALLAS


@pytest.mark.parametrize("affine", ["none", "channel", "bank"])
def test_plain_k1k2_matches_pallas_interpret(rng, affine):
    x, styles, gamma, beta = _case(rng, (2, 3, 3, 3, 256), affine)
    pallas = fused_instance_norm_act(
        jnp.asarray(x), None if gamma is None else jnp.asarray(gamma),
        None if beta is None else jnp.asarray(beta), jnp.asarray(styles),
        interpret=True)
    assert max_err(_port(x, styles, gamma, beta), pallas) <= ATOL_PALLAS


def test_out_of_range_styles_clamp(rng):
    x, _, gamma, beta = _case(rng, (2, 4, 4, 4, 16), "bank")
    styles = np.array([-3, 7], np.int32)
    want = _jax_two_pass(x, np.array([0, 1], np.int32), gamma, beta)
    assert max_err(_port(x, styles, gamma, beta), want) <= ATOL_TWO_PASS
    assert max_err(_port(x, styles, gamma, beta),
                   _jax_two_pass(x, styles, gamma, beta)) <= ATOL_TWO_PASS


def test_small_variance_channel_needs_two_pass(rng):
    """A channel with var << mean^2 (ROADMAP W1), held against a float64
    two-pass truth: the port's two-pass statistics pass at 1e-5, the
    one-pass Pallas fold does not.  (Both f32 sums drift from the truth
    here; the float64 reference keeps the comparison about the variance
    formula, not about summation order.)"""
    x = rng.standard_normal((1, 8, 8, 16, 16)).astype(np.float32)
    x[..., 3] = 0.3 + 0.01 * x[..., 3]         # mean 0.3, var 1e-4
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3), keepdims=True)
    var = ((x64 - mean) ** 2).mean(axis=(1, 2, 3), keepdims=True)
    truth = (x64 - mean) / np.sqrt(var + 1e-5)
    assert max_err(_port(x, np.zeros(1, np.int32), None, None), truth) <= ATOL_TWO_PASS
    one_pass = fused_instance_norm_act(jnp.asarray(x), interpret=True)
    assert max_err(one_pass, truth) > ATOL_TWO_PASS


def test_functional_norms_match_jax(rng):
    x = rng.standard_normal((2, 5, 6, 7, 8)).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    b = (0.2 * rng.standard_normal(8)).astype(np.float32)
    gs = np.stack([g, g[::-1]])
    bs = np.stack([b, -b])
    styles = np.array([1, 0], np.int32)
    pairs = [
        (TN.instance_norm(t(x)), JN.instance_norm(jnp.asarray(x))),
        (TN.instance_norm(t(x), t(g), t(b)),
         JN.instance_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        (TN.conditional_instance_norm(t(x), t(styles), t(gs), t(bs)),
         JN.conditional_instance_norm(jnp.asarray(x), jnp.asarray(styles),
                                      jnp.asarray(gs), jnp.asarray(bs))),
        (TN.layer_norm(t(x), t(g), t(b)),
         JN.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
    ]
    for got, want in pairs:
        assert max_err(got, want) <= ATOL_TWO_PASS
    for name in ("instance_cond", "instance", "batch", "layer", "group", "none"):
        assert TN.parse_normalization(name, num_styles=3) == \
            JN.parse_normalization(name, num_styles=3)


def test_norm_module_matches_flax(rng):
    from miseg_tpu.nn.norms import Norm as JNorm
    from miseg_tpu_torch.nn.norms import Norm as TNorm
    x = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    add = rng.standard_normal(x.shape).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    for kind in ("instance_cond", "instance"):
        params = {"scale": (1 + 0.2 * rng.standard_normal(
                      (2, 8) if kind == "instance_cond" else (8,))).astype(np.float32)}
        params["bias"] = (0.2 * rng.standard_normal(params["scale"].shape)).astype(np.float32)
        want = JNorm(kind=kind, features=8).apply(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x),
            jnp.asarray(mods), act_slope=0.01, add=jnp.asarray(add))
        port = TNorm(kind, 8, device="cpu")
        port.load_state_dict({k: t(v) for k, v in params.items()}, strict=True)
        got = port(t(x), t(mods), act_slope=0.01, add=t(add))
        assert max_err(got, want) <= ATOL_TWO_PASS


def _tail_args(rng, shape, tail):
    """(act_slope, add) of a norm's trailing `y (+ add) -> leaky` tail."""
    if tail == "none":
        return None, None
    return 0.01, rng.standard_normal(shape).astype(np.float32)


def _affine_params(rng, c, affine):
    if not affine:
        return {}
    return {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.2 * rng.standard_normal(c)).astype(np.float32)}


@pytest.mark.parametrize("tail", ["none", "add_slope"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("num_groups", [4, 8])
def test_group_norm_matches_flax(rng, num_groups, affine, tail):
    """The port's `group` Norm (two-pass statistics over each group's
    spatial extent and channels) against flax's, with and without the
    tail the dynunet blocks pass to any norm kind."""
    from miseg_tpu.nn.norms import Norm as JNorm
    from miseg_tpu_torch.nn.norms import Norm as TNorm
    x = (rng.standard_normal((2, 4, 5, 3, 16)) * 2 + 0.5).astype(np.float32)
    slope, add = _tail_args(rng, x.shape, tail)
    params = _affine_params(rng, 16, affine)
    want = JNorm(kind="group", features=16, num_groups=num_groups, affine=affine).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x), act_slope=slope,
        add=None if add is None else jnp.asarray(add))
    port = TNorm("group", 16, affine=affine, num_groups=num_groups, device="cpu")
    port.load_state_dict({k: t(v) for k, v in params.items()}, strict=True)
    got = port(t(x), act_slope=slope, add=None if add is None else t(add))
    assert max_err(got, want) <= ATOL_TWO_PASS


@pytest.mark.parametrize("tail", ["none", "add_slope"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(rng, train, tail):
    """The port's `batch` Norm against flax's with a mutable `batch_stats`:
    in training the batch's statistics normalise and the f32 buffers take
    `0.9 old + 0.1 new`; in eval the buffers normalise and stay."""
    from miseg_tpu.nn.norms import Norm as JNorm
    from miseg_tpu_torch.nn.norms import Norm as TNorm
    x = (rng.standard_normal((2, 4, 5, 3, 8)) * 2 + 0.5).astype(np.float32)
    slope, add = _tail_args(rng, x.shape, tail)
    params = _affine_params(rng, 8, True)
    stats = {"mean": (0.2 * rng.standard_normal(8)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    want, new = JNorm(kind="batch", features=8).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
        act_slope=slope, add=None if add is None else jnp.asarray(add),
        mutable=["batch_stats"])
    port = TNorm("batch", 8, device="cpu")
    port.load_state_dict({k: t(v) for k, v in {**params, **stats}.items()}, strict=True)
    port.train(train)
    got = port(t(x), act_slope=slope, add=None if add is None else t(add))
    assert max_err(got, want) <= ATOL_TWO_PASS
    for name in ("mean", "var"):
        buf = getattr(port, name)
        assert buf.dtype == torch.float32 and not buf.requires_grad
        assert max_err(buf, new["batch_stats"][name]) <= 1e-6
        assert np.array_equal(buf.numpy(), stats[name]) == (not train)


def test_batch_stats_are_one_pass(rng):
    """A channel with var << mean^2 whose one-pass `E[x^2] - mean^2` is
    exactly 0 in f32 whatever the summation order (64 +- 1/128: every sum
    exact), while its two-pass variance is (1/128)^2: the port's batch
    norm follows JAX's one-pass statistics, not `F.batch_norm`'s."""
    import torch.nn.functional as F

    from miseg_tpu.nn.norms import Norm as JNorm
    from miseg_tpu_torch.nn.norms import Norm as TNorm
    x = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    signs = rng.permutation(np.repeat([-1.0, 1.0], 64)).reshape(2, 4, 4, 4)
    x[..., 0] = 64.0 + signs / 128.0
    assert float(TN.batch_stats(t(x))[1][0]) == 0.0
    assert float(JN.batch_stats(jnp.asarray(x))[1][0]) == 0.0
    params = {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    stats = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}
    want, _ = JNorm(kind="batch", features=4).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    port = TNorm("batch", 4, device="cpu").train()
    port.load_state_dict({k: t(v) for k, v in {**params, **stats}.items()}, strict=True)
    got = port(t(x))
    assert max_err(got, want) <= ATOL_TWO_PASS
    two_pass = F.batch_norm(t(x).permute(0, 4, 1, 2, 3), None, None, training=True)
    assert max_err(got[..., 0], two_pass[:, 0]) > 1.0


@pytest.mark.parametrize("s,c", [(96 ** 3, 48), (48 ** 3, 48), (27, 3072), (6 ** 3, 768)])
def test_k1_grid_fills_the_card(s, c):
    """`miseg_k1_stats`' grid on a 132-SM H100, for 16-byte loads of bf16
    (8 channels) and f32 (4): a CTA's threads each keep one channel group,
    its row chunks are whole steps of 8 rows a lane and tile S exactly, and
    the grid holds more CTAs than the card has SMs, or else every sample is
    one chunk and folds in its own CTA.  The main path's C = 48 in bf16
    takes whole rows; wide channels over short rows split over channel
    blocks instead of rows."""
    for vec in (8, 4):
        block_c, threads, rows, n_chunks = fused_norm.stats_grid(1, s, c, 132, vec)
        groups = block_c // vec
        assert block_c % vec == 0 and groups <= 8
        assert threads <= 256 and threads % groups == 0 and threads * vec <= 2048
        assert rows % (threads // groups * 8) == 0
        assert (n_chunks - 1) * rows < s <= n_chunks * rows
        ctas = n_chunks * -(-c // block_c)
        assert ctas >= 132 or n_chunks == 1, (vec, ctas, n_chunks)
        if s >= 48 ** 3:
            assert ctas >= 132 and (vec == 4 or block_c == c)
        if c == 3072:
            assert n_chunks == 1 and -(-c // block_c) >= 132


# (batch, S, C, element size, the load width K2/K3 take): the served
# path's widest (27 x 3072), largest (48^3 x 48) and smallest (27 x 768)
# K2 shapes and K3's 96^3 x 48 in bf16; C = 100 over 3 samples, the scalar
# variant in bf16; f32 at C = 48 (4 channels a load) and at C = 3072,
# whose 768 channel groups are more than a CTA's threads (the scalar
# variant)
_APPLY = {
    "bf16_27_3072": (1, 27, 3072, 2, 8),
    "bf16_27_768": (1, 27, 768, 2, 8),
    "bf16_48cube_48": (1, 48 ** 3, 48, 2, 8),
    "bf16_96cube_48": (1, 96 ** 3, 48, 2, 8),
    "bf16_c100_b3": (3, 4 ** 3, 100, 2, 1),
    "f32_48cube_48": (1, 48 ** 3, 48, 4, 4),
    "f32_27_3072": (1, 27, 3072, 4, 1),
}


@pytest.mark.parametrize("num_sms,ctas_per_sm", [(132, 3), (114, 8)])   # H100 SXM, PCIe
@pytest.mark.parametrize("case", sorted(_APPLY))
def test_apply_grid(case, num_sms, ctas_per_sm):
    """K2/K3's grid: 16-byte loads where C allows, a CTA's threads a
    multiple of its channel groups (so each thread keeps one group's
    columns), rows of `threads` vectors covered in whole steps: one step
    of 4 rows a CTA where that makes at least 4 waves of the CTAs the card
    holds, else at most one wave striding over steps of 2 rows; small
    tensors spread over CTAs of fewer threads."""
    bsz, s, c, size, vec = _APPLY[case]
    assert fused_norm.apply_vec(c, size) == vec
    n = s * c
    threads, ctas, unroll = fused_norm.apply_grid(bsz, n, c, vec, num_sms, ctas_per_sm)
    assert 1 <= threads <= 512
    groups = c // vec if vec > 1 else 1
    assert threads % groups == 0
    nvec = -(-n // vec)
    rows = -(-nvec // threads)
    wave = max(1, ctas_per_sm * num_sms // bsz)
    steps = -(-rows // unroll)
    assert 1 <= ctas <= steps                          # no CTA without a step
    if unroll == 4:
        assert ctas == steps >= 4 * wave               # one step a CTA, many waves
    else:
        assert unroll == 2 and ctas == min(steps, wave) and -(-rows // 4) < 4 * wave
    if s >= 96 ** 3:
        assert unroll == 4 and threads == groups * (192 // groups)
    if bsz * -(-nvec // (groups * max(1, 192 // groups))) < num_sms:
        assert threads == groups * -(-64 // groups) and ctas == steps   # small: every step its CTA


def _tile_partials(x, rows):
    """Per-tile (mean, M2) `f32 [2, B * n_tiles, C]` of x `[B, S, C]` in
    tiles of `rows` rows, only a sample's last short, taken two-pass as
    K4's epilogue takes them."""
    b, s, c = x.shape
    n = -(-s // rows)
    out = np.zeros((2, b * n, c), np.float32)
    for i in range(b):
        for k in range(n):
            tile = x[i, k * rows:(k + 1) * rows]
            mean = tile.mean(axis=0, dtype=np.float32)
            out[0, i * n + k] = mean
            out[1, i * n + k] = ((tile - mean) ** 2).sum(axis=0, dtype=np.float32)
    return out, n


# (batch, S, C, tile rows, affine): one short tile; exactly 256 tiles; 257
# with a short last one; 3456 with a short last one (K4's brick count at
# 96^3); batch 2 with conditional banks whose style ids clamp
_FOLDS = {
    "one_tile": (1, 5, 8, 8, "none"),
    "tiles_256": (1, 768, 16, 3, "channel"),
    "tiles_257": (1, 770, 16, 3, "bank"),
    "tiles_3456_short": (1, 6911, 8, 2, "channel"),
    "b2_bank_clamps": (2, 300, 16, 7, "bank"),
}


@pytest.mark.parametrize("case", sorted(_FOLDS))
def test_plain_fold_matches_stats_and_jax(rng, case):
    """`fold_partials_plain` on K4-style partials of a seeded x against the
    plain statistics of x itself (1e-5 relative: the same two-pass math
    in another order) and the JAX package's `norm_columns` of x's (sum,
    sum^2) (1e-4 relative: JAX folds a one-pass variance)."""
    from miseg_tpu.ops.pallas import fused_norm as jfn
    bsz, s, c, rows, affine = _FOLDS[case]
    x = (rng.standard_normal((bsz, s, c)) + 0.5).astype(np.float32)
    _, styles, gamma, beta = _case(rng, (bsz, 1, c), affine)
    if affine == "bank":
        styles = np.array([5, -1][:bsz], np.int32)   # clamp to banks 1 and 0
    part, n_tiles = _tile_partials(x, rows)
    g, b = (None, None) if gamma is None else (t(gamma), t(beta))
    got = fused_norm.fold_partials_plain(t(part), s, rows, n_tiles, g, b, t(styles))
    want = fused_norm.channel_scale_shift_plain(t(x), g, b, t(styles))
    stats = np.stack([x.sum(axis=1), (x.astype(np.float64) ** 2).sum(axis=1)], axis=1)
    jax_cols = jfn.norm_columns(jnp.asarray(stats, jnp.float32), s,
                                None if gamma is None else jnp.asarray(gamma),
                                None if beta is None else jnp.asarray(beta),
                                jnp.asarray(styles))
    for a, ref, jref in zip(got, want, jax_cols):
        assert a.shape == (bsz, c)
        assert max_err(a, ref) <= 1e-5 * (1 + float(ref.abs().max()))
        assert max_err(a, jref) <= 1e-4 * (1 + float(np.abs(np.asarray(jref)).max()))
    # the wrapper takes the plain fold for CPU tensors and counts no launch
    before = fused_norm.fold_launches
    again = fused_norm.fold_partials(t(part), s, rows, n_tiles, g, b, t(styles))
    assert fused_norm.fold_launches == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_plain_fold_small_variance_channel(rng):
    """A channel with var << mean^2 (ROADMAP W1) through the plain fold of
    tile partials: the normalised x within test_small_variance_channel_
    needs_two_pass's bound of a float64 two-pass truth."""
    x = rng.standard_normal((1, 8 * 8 * 16, 16)).astype(np.float32)
    x[..., 3] = 0.3 + 0.01 * x[..., 3]         # mean 0.3, var 1e-4
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=1, keepdims=True)
    truth = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(axis=1, keepdims=True) + 1e-5)
    part, n_tiles = _tile_partials(x, 64)
    scale, shift = fused_norm.fold_partials_plain(t(part), x.shape[1], 64, n_tiles)
    got = t(x) * scale[:, None, :] + shift[:, None, :]
    assert max_err(got, truth) <= ATOL_TWO_PASS
