"""The batch-norm C-UNet's deepest gradients at depth 5 (ROADMAP Queue 3,
F1, settled as trap W11): the port's f32 against JAX's f32, both against
an exact evaluation.

`scripts/torch_grad_precision.py`'s model (`chip_smoke.CUNET` with batch
norms, depth 5, 64^3, batch 2) from JAX's seeded weights, bridged, on
one seeded batch in train mode:
  * JAX's f32 `value_and_grad` (the reference package as it runs);
  * the port's f32 gradients;
  * an exact evaluation: the port in f64 with the batch norm's statistics
    and normalisation in f64 too (both packages take the statistics in
    f32 whatever the input's dtype, so their "f64" runs are not exact).
Each gap is a leaf's largest |difference| as a share of that leaf's
largest exact element.  What it shows:
  * the port's f32 lies within `BOUND` of JAX's f32 at every leaf
    (measured 8.45e-3 on the CPU, the worst leaf `model.sub.sub.up.weight`);
  * JAX's own f32 lies further from exact (measured 1.42e-1, at
    `model.sub.sub.sub.bottom.unit1.conv.weight`), and so does the
    port's: the 1-2% of F1 are a property of the model, not of the port;
  * the ill-conditioned operation is PReLU's gate at 0 (`x >= 0`): a few
    of the bottom unit's inputs lie within f32 rounding of 0 and take the
    other branch in f32 than exactly, and each carries (1 - slope) of its
    gradient onto leaves whose whole gradient is ~1e-5.  Computing the
    one-pass variance in two passes moves nothing (the other suspect).
The module takes ~50 s on the CPU (JAX's jitted step ~15 s of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import seeded_params

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.losses import loss_from_config
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.nn.factories import PReLU
from miseg_tpu_torch.ops import norms as N
from miseg_tpu_torch.weights import state_dict_from_jax

SIZE, DEPTH = 64, 5
BOUND = 1e-2      # the port's f32 against JAX's f32, a share of the leaf
CFG = dict(model_name="unet", out_channels=6, feature_size=[16], roi_x=SIZE, roi_y=SIZE,
           roi_z=SIZE, encoder_norm_name="batch", decoder_norm_name="batch", no_amp=True,
           num_layers=DEPTH, strides=[2] * (DEPTH - 1))
BOTTOM_ACT = "model.sub.sub.sub.bottom.unit1.adn.A"


def _exact_stats(x):
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    return mean, (x - mean).square().mean(dim=dims)


def _two_pass_f32(x):
    x = x.float()
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    return mean, (x - mean).square().mean(dim=dims)


def _exact_norm(x, mean, var, gamma, beta, *, eps=1e-5):
    y = (x - mean) * torch.rsqrt(var + eps)
    return y if gamma is None else y * gamma + beta


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    label = rng.integers(0, 6, (2, SIZE, SIZE, SIZE)).astype(np.int32)
    mods = np.array([0, 1], np.int32)
    jcfg = JConfig(**CFG)
    jmodel = jax_model_from_config(jcfg)
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(mods))["batch_stats"]
    stats = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes)
    jloss = JL.loss_from_config(jcfg)

    def loss_of(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, x, mods, train=True,
                                 mutable=["batch_stats"])
        return jloss(logits, label)

    grads = jax.jit(jax.grad(loss_of))(params)
    out = {"jax32": {n: g.double() for n, g in state_dict_from_jax(
        jax.tree.map(np.array, grads)).items()}}
    start = state_dict_from_jax(params, stats)
    cfg = Config(**CFG)
    acts = {}

    def port(dtype, name):
        model = model_from_config(cfg, device="cpu", dtype=dtype)
        model.load_state_dict({k: v.to(dtype) for k, v in start.items()})
        model.train()
        seen = acts.setdefault(name, {})
        for n, m in model.named_modules():
            if isinstance(m, PReLU):
                m.register_forward_hook(
                    lambda m, i, o, n=n: seen.__setitem__(n, i[0].detach().double()))
        logits = model(torch.from_numpy(x).to(dtype), torch.from_numpy(mods))
        loss_from_config(cfg)(logits, torch.from_numpy(label).long()).backward()
        out[name] = {n: p.grad.detach().double() for n, p in model.named_parameters()}

    port(torch.float32, "port32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(N, "batch_stats", _two_pass_f32)
        port(torch.float32, "two_pass32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(N, "batch_stats", _exact_stats)
        mp.setattr(N, "batch_norm_inference", _exact_norm)
        port(torch.float64, "exact")
    out["acts"] = acts
    return out


def _worst(runs, a: str, b: str):
    """(the largest gap as a share of its leaf's largest exact element,
    that leaf) of runs `a` against `b`."""
    exact = runs["exact"]
    rows = [(float((runs[a][n] - runs[b][n]).abs().max()) / float(exact[n].abs().max()), n)
            for n in exact if float(exact[n].abs().max()) > 1e-6]
    return max(rows)


def test_port_f32_gradients_are_jax_f32_within_the_bound(runs):
    share, leaf = _worst(runs, "port32", "jax32")
    jax_share, jax_leaf = _worst(runs, "jax32", "exact")
    port_share, _ = _worst(runs, "port32", "exact")
    print(f"depth {DEPTH} batch-norm C-UNet {SIZE}^3: port f32 vs JAX f32 {share:.3e} ({leaf}); "
          f"JAX f32 vs exact {jax_share:.3e} ({jax_leaf}); port f32 vs exact "
          f"{port_share:.3e}")
    assert share <= BOUND
    # W11: JAX's own f32 is further from exact than the port is from JAX
    assert jax_share > share and ".bottom." in jax_leaf


def test_the_ill_conditioned_operation_is_prelus_gate(runs):
    """Only PReLU inputs within f32 rounding of 0 change branch, among them
    the bottom unit's, whose leaves carry JAX's worst gap."""
    f32, exact = runs["acts"]["port32"], runs["acts"]["exact"]
    flips = {n: int(((f32[n] >= 0) != (exact[n] >= 0)).sum()) for n in exact}
    print(f"PReLU branch flips f32 vs exact: {flips}")
    assert flips[BOTTOM_ACT] > 0
    for n, k in flips.items():
        if k:   # every flipped input lies within f32 rounding of 0
            gap = (f32[n] - exact[n]).abs().max()
            assert float(exact[n][(f32[n] >= 0) != (exact[n] >= 0)].abs().max()) <= gap
    assert sum(flips.values()) < 1e-4 * sum(v.numel() for v in exact.values())


def test_the_one_pass_variance_is_not_it(runs):
    """The other suspect: f32 statistics in two passes leave the deep gap
    where it was (measured 1.42e-1 either way)."""
    one_pass, _ = _worst(runs, "port32", "exact")
    two_pass, leaf = _worst(runs, "two_pass32", "exact")
    print(f"port f32 vs exact: one-pass variance {one_pass:.3e}, two-pass {two_pass:.3e} "
          f"({leaf})")
    assert two_pass > BOUND and abs(two_pass - one_pass) < 0.1 * one_pass
