"""Each kernel's autograd Function in the port (`miseg_tpu_torch.ops.kernels`,
and the rel-pos bias gather) against `jax.vjp` of its JAX entry on the CPU
(f32), the Pallas kernels in interpret mode: atol 2e-5 on every input's
cotangent.  The bound is absolute, so the shapes stay small enough that a
parameter's cotangent (a sum over B * S elements) is O(10): at
[2, 8^3, 16], where dgamma is ~75, the JAX side alone is 3e-5 from a
float64 reference (the port 9e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, t

from miseg_tpu.ops.pallas import fused_conv as jfc
from miseg_tpu.ops.pallas import fused_norm as jfn
from miseg_tpu.ops.pallas.window_attention import fused_window_attention
from miseg_tpu.ops.rel_bias import rel_bias_gather as j_rel_bias_gather
from miseg_tpu_torch.ops import rel_bias
from miseg_tpu_torch.ops.kernels import fused_conv, fused_norm
from miseg_tpu_torch.ops.kernels import window_attention as wa

torch.set_num_threads(1)
ATOL_VJP = 2e-5


def _jopt(a):
    return None if a is None else jnp.asarray(a)


def _port_vjp(fn, primals, cts):
    """(outputs, cotangents of the float primals, None for the others)."""
    ins = [None if a is None else t(a).requires_grad_(a.dtype == np.float32) for a in primals]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, t(c)) for o, c in zip(outs, cts) if c is not None]
    leaves = [a for a in ins if a is not None and a.requires_grad]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs]))
    return outs, [next(grads) if a is not None and a.requires_grad else None for a in ins]


def _jax_vjp(fn, primals, cts, float_mask):
    """jax.vjp of `fn` over the primals marked in `float_mask` (the others
    closed over); a None cotangent is zeros."""
    idx = [i for i, m in enumerate(float_mask) if m]

    def f(*diff):
        args = list(primals)
        for i, d in zip(idx, diff):
            args[i] = d
        return fn(*args)

    outs, vjp = jax.vjp(f, *[jnp.asarray(primals[i]) for i in idx])
    outs = outs if isinstance(outs, tuple) else (outs,)
    full = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c) for o, c in zip(outs, cts))
    got = vjp(full if len(full) > 1 else full[0])
    res = [None] * len(primals)
    for i, g in zip(idx, got):
        res[i] = g
    return outs, res


def _check_vjp(port_fn, jax_fn, primals, cts, name):
    mask = [a is not None and a.dtype == np.float32 for a in primals]
    _, grads = _port_vjp(port_fn, primals, cts)
    _, jgrads = _jax_vjp(jax_fn, [_jopt(a) for a in primals], cts, mask)
    errs = []
    for g, jg in zip(grads, jgrads):
        if jg is None:
            continue
        errs.append(max_err(g, jg))
    print(f"{name}: max |grad diff| per input {['%.1e' % e for e in errs]}")
    assert max(errs) <= ATOL_VJP, errs


def _rand(rng, shape, scale=1.0, mean=0.0):
    return (mean + scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------- K1 / K2 / K3 ----

@pytest.mark.parametrize("affine,slope,with_add", [("none", None, False),
                                                   ("channel", 0.01, True),
                                                   ("bank", None, False),
                                                   ("bank", 0.01, True)])
def test_instance_norm_act_vjp_matches_jax(rng, affine, slope, with_add):
    """K1 + K2 Functions against `fused_instance_norm_act`'s custom VJP;
    style 7 is out of range, so its rows' gradients go to bank 1."""
    shape, c = (2, 4, 4, 4, 16), 16
    x = _rand(rng, shape, 1.5, 0.3)
    gamma = beta = None
    if affine == "channel":
        gamma, beta = _rand(rng, c, 0.3, 1.0), _rand(rng, c, 0.3)
    elif affine == "bank":
        gamma, beta = _rand(rng, (2, c), 0.3, 1.0), _rand(rng, (2, c), 0.3)
    styles = np.array([1, 7], np.int32)
    add = _rand(rng, shape) if with_add else None
    _check_vjp(
        lambda x_, g_, b_, s_, a_: fused_norm.instance_norm_act(
            x_, g_, b_, s_, negative_slope=slope, add=a_),
        lambda x_, g_, b_, s_, a_: jfn.fused_instance_norm_act(
            x_, g_, b_, s_, negative_slope=slope, add=a_, interpret=True),
        [x, gamma, beta, styles, add], [_rand(rng, shape)], f"K1+K2 {affine}")


@pytest.mark.parametrize("affine,which", [("none", "both"), ("channel", "both"),
                                          ("bank", "both"), ("bank", "scale"),
                                          ("bank", "shift")])
def test_k1_columns_vjp_matches_jax(rng, affine, which):
    """K1's Function (x -> f32 columns) against `channel_stats` +
    `norm_columns`, with a cotangent on both columns or on one alone."""
    shape, c = (2, 6, 6, 6, 16), 16
    x = _rand(rng, shape, 1.5, 0.3)
    gamma = beta = None
    if affine == "channel":
        gamma, beta = _rand(rng, c, 0.3, 1.0), _rand(rng, c, 0.3)
    elif affine == "bank":
        gamma, beta = _rand(rng, (2, c), 0.3, 1.0), _rand(rng, (2, c), 0.3)
    styles = np.array([-2, 1], np.int32)
    cts = [_rand(rng, (2, c)) if which in ("both", "scale") else None,
           _rand(rng, (2, c)) if which in ("both", "shift") else None]
    _check_vjp(
        lambda x_, g_, b_, s_: fused_norm.channel_scale_shift(
            x_.reshape(2, -1, c), g_, b_, s_),
        lambda x_, g_, b_, s_: jfn.norm_columns(
            jfn.channel_stats(x_, interpret=True), 216, g_, b_, s_),
        [x, gamma, beta, styles], cts, f"K1 {affine} {which}")


@pytest.mark.parametrize("slope", [None, 0.01])
def test_k2_vjp_matches_jax(rng, slope):
    shape = (2, 4, 4, 8, 16)
    _check_vjp(
        lambda x_, s_, h_: fused_norm.apply_norm_act(x_, s_, h_, negative_slope=slope),
        lambda x_, s_, h_: jfn.apply_norm_act(x_, s_, h_, negative_slope=slope,
                                              interpret=True),
        [_rand(rng, shape), _rand(rng, (2, 16), 0.3, 1.0), _rand(rng, (2, 16), 0.3)],
        [_rand(rng, shape)], f"K2 slope={slope}")


@pytest.mark.parametrize("slope", [None, 0.01])
def test_k3_vjp_matches_jax(rng, slope):
    shape = (2, 4, 4, 8, 16)
    cols = [_rand(rng, (2, 16), 0.3, 1.0), _rand(rng, (2, 16), 0.3)]
    cols_r = [_rand(rng, (2, 16), 0.3, 1.0), _rand(rng, (2, 16), 0.3)]
    _check_vjp(
        lambda *a: fused_norm.apply_norm2_act(*a, negative_slope=slope),
        lambda *a: jfn.apply_norm2_act(*a, negative_slope=slope, interpret=True),
        [_rand(rng, shape), *cols, _rand(rng, shape), *cols_r],
        [_rand(rng, shape)], f"K3 slope={slope}")


# ------------------------------------------------------------------ K4 ----

@pytest.mark.parametrize("prologue,affine,cts_on", [("none", "bank", "all"),
                                                    ("none", "channel", "columns"),
                                                    ("affine_leaky", "channel", "all"),
                                                    ("affine_leaky", "bank", "columns")])
def test_k4_vjp_matches_jax(rng, prologue, affine, cts_on):
    """K4's Function (conv, statistics and fold) against
    `conv3_norm_stats` + `norm_columns`; "columns" puts the cotangent on
    next_scale/next_shift alone, the path only the statistics carry."""
    b, cin, cout = 2, 5, 6
    shape = (b, 4, 4, 6, cin)
    x = _rand(rng, shape, 1.0, 0.2)
    w = _rand(rng, (3, 3, 3, cin, cout), 0.2)
    scale = shift = slope = None
    if prologue != "none":
        scale, shift, slope = _rand(rng, (b, cin), 0.3, 1.0), _rand(rng, (b, cin), 0.3), 0.01
    if affine == "channel":
        gamma, beta, styles = _rand(rng, cout, 0.2, 1.0), _rand(rng, cout, 0.2), None
    else:
        gamma, beta = _rand(rng, (2, cout), 0.2, 1.0), _rand(rng, (2, cout), 0.2)
        styles = np.array([1, 9], np.int32)
    n = int(np.prod(shape[1:-1]))
    cts = [None if cts_on == "columns" else _rand(rng, (*shape[:-1], cout)),
           _rand(rng, (b, cout)), _rand(rng, (b, cout))]

    def port(x_, w_, sc_, sh_, g_, b_, s_):
        return fused_conv.conv3_norm_columns(
            x_, w_.permute(4, 3, 0, 1, 2), sc_, sh_, slope=slope, gamma=g_, beta=b_, styles=s_)

    def jax_fn(x_, w_, sc_, sh_, g_, b_, s_):
        y, stats = jfc.conv3_norm_stats(x_, w_, sc_, sh_, slope=slope, interpret=True)
        return (y, *jfn.norm_columns(stats, n, g_, b_, s_))

    _check_vjp(port, jax_fn, [x, w, scale, shift, gamma, beta, styles], cts,
               f"K4 {prologue} {affine} {cts_on}")


def test_k4_cin1_skips_dx(rng):
    """Encoder1's Cin = 1 conv: x is the image and takes no gradient, so
    the backward computes none (only dw and the columns' gradients)."""
    x = t(_rand(rng, (1, 4, 4, 4, 1)))
    w = t(_rand(rng, (8, 1, 3, 3, 3), 0.3)).requires_grad_(True)
    gamma = t(_rand(rng, 8, 0.2, 1.0)).requires_grad_(True)
    y, sc, sh = fused_conv.conv3_norm_columns(x, w, gamma=gamma, beta=torch.zeros(8))
    assert y.grad_fn is not None and "Conv3NormColumns" in type(y.grad_fn).__name__
    dy = torch.randn_like(y)
    grads = fused_conv.conv3_norm_columns_bwd(
        x, w.detach(), None, None, y.detach(), dy, None, None, gamma=gamma.detach(),
        beta=torch.zeros(8), needs=(False, True, False, False, True, True))
    assert grads[0] is None and grads[1] is not None
    (dw,) = torch.autograd.grad(y, w, dy)
    assert max_err(dw, grads[1]) == 0.0


# ------------------------------------------------------------------ K5 ----

@pytest.mark.parametrize("case", ["n343_mask", "n216_nomask"])
def test_k5_vjp_matches_jax(rng, monkeypatch, case):
    """K5's Function against `fused_window_attention`'s VJP (f32 P
    recomputed): a full 7^3 window with a region mask, its backward taken
    whole and cut into one-window chunks (each chunk picking its windows'
    mask rows), and a clipped 6^3 window."""
    n, mask = (343, True) if case == "n343_mask" else (216, False)
    bw, c, heads = 4, 12, 2
    qkv = _rand(rng, (bw, n, 3 * c))
    bias = _rand(rng, (heads, n, n), 0.5)
    ids = rng.integers(0, 3, (2, n)).astype(np.int32) if mask else None
    cts = [_rand(rng, (bw, n, c))]

    def port(qkv_, b_, i_):
        return wa.window_attention(qkv_[..., :c], qkv_[..., c:2 * c], qkv_[..., 2 * c:], b_, i_,
                                   num_heads=heads)

    jax_fn = (lambda qkv_, b_, i_: fused_window_attention(
        qkv_[..., :c], qkv_[..., c:2 * c], qkv_[..., 2 * c:], b_, i_, num_heads=heads,
        interpret=True))
    _, want = _jax_vjp(jax_fn, [jnp.asarray(qkv), jnp.asarray(bias), _jopt(ids)], cts,
                       [True, True, False])
    for chunk in (wa._BWD_CHUNK, 1):
        monkeypatch.setattr(wa, "_BWD_CHUNK", chunk)
        _, got = _port_vjp(port, [qkv, bias, ids], cts)
        errs = [max_err(g, w) for g, w in zip(got[:2], want[:2])]
        print(f"K5 {case} chunk {chunk}: max |grad diff| {['%.1e' % e for e in errs]}")
        assert max(errs) <= ATOL_VJP, errs


@pytest.mark.parametrize("n", [343, 216, 100])
def test_rel_bias_gather_vjp_matches_jax(rng, n):
    """The separable gather backward, full window and the clipped
    `[:n, :n]` prefix (W4)."""
    ws, heads = (7, 7, 7), 3
    table_t = _rand(rng, (heads, 13 ** 3), 0.02)
    _check_vjp(lambda tt: rel_bias.rel_bias_gather(tt, ws)[:, :n, :n],
               lambda tt: j_rel_bias_gather(tt, ws)[:, :n, :n],
               [table_t], [_rand(rng, (heads, n, n))], f"rel bias n={n}")
