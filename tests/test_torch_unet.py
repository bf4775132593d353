"""The port's residual UNets (`unet`, `unet_vanilla`) against the JAX
package (CPU, f32).

* Whole-model logits through `model_from_config` on bridged weights, at
  16^3, batch 2, modalities [1, 0]: C-UNet with `num_res_units` 0 (the
  top `up` conv-only), 1 and 2, strides with a stride-1 level, kernel
  sizes 3 and 5, orderings NDA and ADN, prelu and relu, group norms and
  batch norms (eval mode, seeded running statistics); UNetVanilla at the
  README recipe's shape with narrow channels ([4, 8, 8, 16, 16], strides
  1 2 2 2 1, `num_res_units` 3, 8 classes), and with batch + group norms.
  atol 2e-4, as the other models are held (the largest gap seen is
  printed).
* The length checks, `ENCODER_PREFIXES` through `freeze_mask` against
  JAX's `freeze_mask`.
* The weight bridge: C-UNet's transposed `up` kernels against JAX, the
  previous name rule as a negative control; swin_unetr's and unetr's
  bridged state dicts unchanged by the new rule; `batch_stats` onto the
  norms' buffers.
* One AdamW `Trainer.train_step` of each model against JAX's jitted
  `value_and_grad` + optax update: the loss within 1e-4, every gradient
  leaf within 5e-5 and their sum within 1e-3 (the flagship's gate, with
  negative controls: zeroing or negating any leaf JAX does not leave at
  0 breaks it), the parameters within the W5 bound (rtol 1e-4 / atol
  2.5e-4); for a batch-norm C-UNet
  also the new running statistics against JAX's mutable `batch_stats`
  (atol 1e-6); then the trainer's eval path on JAX's updated parameters
  and statistics against JAX's eval logits (atol 2e-4).
* PReLU's slope gradient against `jax.grad`.
* `cli.train --model_name unet_vanilla` (8 classes, batch-norm decoder)
  for one epoch, `cli.test` of its best.ckpt, `cli.export` (the bundle's
  forward equals the live model; running statistics f32 in a bf16
  bundle), the HTTP server over the bundle and `cli.predict_whs` with
  MM-WHS label values.
"""

import functools
import json
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t
from test_torch_serve_http import as_nifti, post, write_scan

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.models.unet import UNet as JUNet
from miseg_tpu.models.unet import UNetVanilla as JUNetVanilla
from miseg_tpu.nn.convolutions import Convolution as JConvolution
from miseg_tpu.nn.factories import PReLU as JPReLU
from miseg_tpu.train.optim import freeze_mask as j_freeze_mask
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu.train.pretrained import _flatten, _unflatten
from miseg_tpu_torch import weights
from miseg_tpu_torch.cli import export, parse_args, predict_whs
from miseg_tpu_torch.cli import serve as cli_serve
from miseg_tpu_torch.cli import test as cli_test
from miseg_tpu_torch.cli import train as cli_train
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.nifti import load_nifti
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.models import UNet, UNetVanilla, model_from_config
from miseg_tpu_torch.nn.convolutions import Convolution
from miseg_tpu_torch.nn.factories import PReLU
from miseg_tpu_torch.nn.norms import Norm
from miseg_tpu_torch.serve import load_bundle
from miseg_tpu_torch.train import checkpoint as ckpt
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.train.optim import freeze_mask
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_MODEL = 2e-4
ATOL_BLOCK = 1e-5
ATOL_LOSS = 1e-4
ATOL_STATS = 1e-6
ATOL_LEAF, ATOL_LEAF_SUM = 5e-5, 1e-3
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
SIZE = 16
_UNET = dict(model_name="unet", feature_size=[4], out_channels=4,
             encoder_norm_name="instance_cond", decoder_norm_name="instance",
             roi_x=SIZE, roi_y=SIZE, roi_z=SIZE)
_VANILLA = dict(model_name="unet_vanilla", feature_size=[4, 8, 8, 16, 16],
                strides=[1, 2, 2, 2, 1], num_res_units=3, out_channels=8,
                encoder_norm_name="instance_cond", decoder_norm_name="instance",
                roi_x=SIZE, roi_y=SIZE, roi_z=SIZE)
CASES = {
    "unet_nru0_stride1": dict(_UNET, num_res_units=0, strides=[2, 1, 2]),
    "unet_nru1_k5": dict(_UNET, num_res_units=1, kernel_size=[5]),
    "unet_nru2_adn_relu": dict(_UNET, num_layers=3, strides=[2, 2], adn_ordering="ADN",
                               activation="relu"),
    "unet_group": dict(_UNET, encoder_norm_name="group", decoder_norm_name="group"),
    "unet_batch": dict(_UNET, encoder_norm_name="batch", decoder_norm_name="batch"),
    "vanilla_recipe": _VANILLA,
    "vanilla_batch_group": dict(_VANILLA, num_res_units=1, encoder_norm_name="batch",
                                decoder_norm_name="group", num_groups=2),
}


def seeded_stats(module, *args, seed: int = 1):
    """A `batch_stats` collection shaped like the module's, filled from
    seeded numpy: means ~ N(0, 0.1^2), variances ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args).get("batch_stats", {})
    out = {path: (0.1 * rng.standard_normal(leaf.shape) if path[-1] == "mean"
                  else rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)
           for path, leaf in _flatten(shapes).items()}
    return _unflatten(out) if out else {}


@functools.lru_cache(maxsize=None)
def _jax_model(case: str):
    """(x, modalities, params, batch_stats, JAX eval logits) of a case,
    once per worker."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    jmodel = jax_model_from_config(JConfig(**CASES[case]))
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    stats = seeded_stats(jmodel, jnp.asarray(x), jnp.asarray(mods))
    forward = jax.jit(lambda v, a, m: jmodel.apply(v, a, m))
    want = np.asarray(forward({"params": params, **({"batch_stats": stats} if stats else {})},
                              jnp.asarray(x), jnp.asarray(mods)))
    return x, mods, params, stats, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet_matches_jax(case):
    x, mods, params, stats, want = _jax_model(case)
    model = model_from_config(Config(**CASES[case]), device="cpu")
    assert isinstance(model, UNet if CASES[case]["model_name"] == "unet" else UNetVanilla)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = model(t(x), t(mods))
    err = max_err(got, want)
    print(f"{case} {SIZE}^3 f32 logits max |port - jax| = {err:.3e} "
          f"(|logits| <= {np.abs(want).max():.2f})")
    assert np.isfinite(got.numpy()).all()
    assert err <= ATOL_MODEL


def test_unet_checks():
    with pytest.raises(ValueError, match="no less than 2"):
        UNet(1, 2, [4], [2], device="cpu")
    with pytest.raises(ValueError, match="len\\(channels\\) - 1"):
        UNet(1, 2, [4, 8, 16], [2], device="cpu")
    with pytest.warns(UserWarning, match="the last 1 values of strides"):
        UNet(1, 2, [4, 8], [2, 2], device="cpu")
    with pytest.raises(ValueError, match="stride a scale"):
        UNetVanilla(1, 2, [4, 8, 16], [1, 2], device="cpu")
    with pytest.raises(NotImplementedError, match="odd kernel"):
        model_from_config(Config(**dict(_UNET, kernel_size=[4])), device="cpu")


@pytest.mark.parametrize("case", ["unet_nru2_adn_relu", "vanilla_recipe"])
def test_encoder_prefixes_freeze_what_jax_freezes(case):
    _, _, params, _, _ = _jax_model(case)
    model = model_from_config(Config(**CASES[case]), device="cpu")
    jcls = JUNet if isinstance(model, UNet) else JUNetVanilla
    assert model.ENCODER_PREFIXES == jcls.ENCODER_PREFIXES
    labels = j_freeze_mask(params, jcls.ENCODER_PREFIXES)
    want = {".".join((*path[:-1], "weight" if path[-1] == "kernel" else path[-1]))
            for path, label in _flatten(labels).items() if label == "freeze"}
    got = freeze_mask(dict(model.named_parameters()), model.ENCODER_PREFIXES)
    assert got == want and 0 < len(got) < len(_flatten(params))


@pytest.mark.parametrize("train", [False, True])
def test_unetr_group_and_batch_norms_match_jax(train):
    """C-UNETR (fs 16, hidden 96, 32^3, batch 2) with `--encoder_norm_name
    batch` and `--decoder_norm_name group`: its dynunet blocks take the
    unfused path with the norm tails applied after the group and batch
    norms.  Eval logits on seeded running statistics, and a training-mode
    forward with its new running statistics, against JAX."""
    cfg = dict(model_name="unetr", out_channels=4, feature_size=[16], hidden_size=96,
               mlp_dim=192, num_heads=12, roi_x=32, roi_y=32, roi_z=32,
               encoder_norm_name="batch", vit_norm_name="instance_cond",
               decoder_norm_name="group")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jmodel = jax_model_from_config(JConfig(**cfg))
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    stats = seeded_stats(jmodel, jnp.asarray(x), jnp.asarray(mods))
    want, new = jax.jit(lambda v, a, m: jmodel.apply(v, a, m, train=train,
                                                     mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x, mods)
    model = model_from_config(Config(**cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model.train(train)
    with torch.no_grad():
        got = model(t(x), t(mods))
    err = max_err(got, want)
    print(f"unetr batch/group train={train} logits max |port - jax| = {err:.3e}")
    assert err <= ATOL_MODEL
    new_sd = state_dict_from_jax({}, jax.tree.map(np.array, new["batch_stats"]))
    buffers = dict(model.named_buffers())
    assert len(new_sd) == len(_flatten(stats)) > 0
    # one-pass statistics of 65,536 voxels summed in another order than
    # XLA's: 1e-5 relative
    for n, v in new_sd.items():
        np.testing.assert_allclose(buffers[n].numpy(), v.numpy(), rtol=1e-5,
                                   atol=ATOL_STATS, err_msg=n)


# ---------------------------------------------------------- the bridge ----

_OLD_RULE = re.compile(r"transp_conv|transp_conv_init|up\d+")


def _old_rule(monkeypatch):
    """The bridge's transposed-conv rule before the UNets: `up` alone was
    read as a plain conv."""
    monkeypatch.setattr(weights, "_is_transposed",
                        lambda module: _OLD_RULE.fullmatch(module) is not None)


def test_bridge_transposes_unet_up_kernels(monkeypatch):
    """C-UNet's inner `up` (a stride-2 transposed conv, 16 + 32 -> 8
    channels, with its ADN) computes JAX's output under the bridge.  Under
    the previous rule the tree no longer loads, and an `up` kernel with as
    many input as output channels loads and computes something else."""
    _, _, params, _, _ = _jax_model("unet_nru2_adn_relu")
    up = params["model"]["sub"]["up"]
    assert up["kernel"].shape == (3, 3, 3, 48, 8)
    model = model_from_config(Config(**CASES["unet_nru2_adn_relu"]), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 4, 4, 4, 48)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    jup = JConvolution(out_channels=8, strides=2, kernel_size=3, act="relu",
                       norm=("instance", {"affine": True}), is_transposed=True,
                       adn_ordering="ADN")
    want = jup.apply({"params": up}, jnp.asarray(y), jnp.asarray(mods))
    with torch.no_grad():
        got = model.model.sub.up(t(y), t(mods))
    # a 1296-term conv, then a norm: 1e-5 relative to the output's scale
    assert max_err(got, want) <= ATOL_BLOCK * (1 + float(np.abs(want).max()))

    square = {"up": {"kernel": rng.standard_normal((3, 3, 3, 8, 8)).astype(np.float32),
                     "bias": np.zeros(8, np.float32)}}
    jsq = JConvolution(out_channels=8, strides=2, kernel_size=3, conv_only=True,
                       is_transposed=True)
    want_sq = jsq.apply({"params": square["up"]}, jnp.asarray(y[..., :8]))
    outputs = []
    for patch in (False, True):
        if patch:
            _old_rule(monkeypatch)
        sd = state_dict_from_jax(square)
        conv = Convolution(8, 8, 3, 2, is_transposed=True, device="cpu")
        conv.load_state_dict({k.removeprefix("up."): v for k, v in sd.items()}, strict=True)
        with torch.no_grad():
            outputs.append(max_err(conv(t(y[..., :8])), want_sq))
    assert outputs[0] <= ATOL_BLOCK < 0.1 < outputs[1], outputs
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(state_dict_from_jax(params), strict=True)


@pytest.mark.parametrize("name", ["swin_unetr", "unetr"])
def test_bridge_keeps_other_models_unchanged(monkeypatch, name):
    """swin_unetr's and unetr's bridged keys, shapes and values are those of
    the previous rule."""
    cfg = dict(model_name=name, out_channels=4, feature_size=[12], num_heads=2,
               hidden_size=96, mlp_dim=192, roi_x=32, roi_y=32, roi_z=32,
               encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
               decoder_norm_name="instance")
    params = seeded_params(jax_model_from_config(JConfig(**cfg)), jnp.zeros((1, 32, 32, 32, 1)),
                           jnp.zeros((1,), jnp.int32))
    new = state_dict_from_jax(params)
    _old_rule(monkeypatch)
    old = state_dict_from_jax(params)
    assert len(new) > 100 and new.keys() == old.keys()
    assert all(torch.equal(new[k], old[k]) for k in new)


def test_bridge_maps_batch_stats_onto_buffers():
    _, _, params, stats, _ = _jax_model("unet_batch")
    sd = state_dict_from_jax(params, stats)
    model = model_from_config(Config(**CASES["unet_batch"]), device="cpu")
    model.load_state_dict(sd, strict=True)
    flat = _flatten(stats)
    buffers = dict(model.named_buffers())
    assert len(flat) == len(buffers) == 2 * 13
    for path, val in flat.items():
        name = ".".join(path)
        assert buffers[name].dtype == torch.float32
        assert np.array_equal(buffers[name].numpy(), val)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(state_dict_from_jax(params), strict=True)


# ---------------------------------------------------------- one step -----

_STEP = dict(criterion="dice_focal", optim_name="adamw", lr=1e-4, reg_weight=1e-5,
             no_amp=True)
STEP_CASES = ["unet_nru2_adn_relu", "unet_batch", "vanilla_recipe"]


@functools.lru_cache(maxsize=None)
def _jax_step(case: str):
    """What JAX's train step computes: the loss and gradients of
    `jax.jit(value_and_grad)` with the mutable `batch_stats`, the
    parameters after one AdamW update,
    the new `batch_stats`, and the eval logits of the updated model."""
    cfg = dict(CASES[case], **_STEP)
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    label = rng.integers(0, cfg["out_channels"], (2, SIZE, SIZE, SIZE)).astype(np.int32)
    mods = np.array([1, 0], np.int32)
    jcfg = JConfig(**cfg)
    jmodel = jax_model_from_config(jcfg)
    _, _, params, stats, _ = _jax_model(case)
    loss_fn = JL.loss_from_config(jcfg)
    extra = {"batch_stats": stats} if stats else {}

    def loss_of(p):
        if not extra:
            return loss_fn(jmodel.apply({"params": p}, image, mods, train=True), label), {}
        logits, new_vars = jmodel.apply({"params": p, **extra}, image, mods, train=True,
                                        mutable=["batch_stats"])
        return loss_fn(logits.astype(jnp.float32), label), new_vars

    jparams = jax.tree.map(jnp.asarray, params)
    (loss, new_vars), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jparams)
    tx = j_optimizer_from_config(jcfg)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, jparams)
    new_stats = jax.tree.map(np.array, dict(new_vars).get("batch_stats", {}))
    logits = np.asarray(jax.jit(lambda v, a, m: jmodel.apply(v, a, m))(
        {"params": new, **({"batch_stats": new_stats} if stats else {})}, image, mods))
    return dict(batch={"image": image, "label": label[..., None], "modality": mods},
                cfg=cfg, params=params, stats=stats, loss=float(loss),
                grads=state_dict_from_jax(jax.tree.map(np.array, grads)),
                new=state_dict_from_jax(jax.tree.map(np.array, new), new_stats),
                logits=logits)


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_jax(case):
    ref = _jax_step(case)
    trainer = engine.Trainer(Config(**ref["cfg"]), device="cpu")
    start = state_dict_from_jax(ref["params"], ref["stats"])
    state = trainer.init_state(start)
    assert len(state.buffers) == (26 if ref["stats"] else 0)
    state, loss = trainer.train_step(state, ref["batch"])
    loss_err = abs(float(loss) - ref["loss"])
    print(f"{case} step: loss {float(loss):.6f} |diff| {loss_err:.2e}")
    assert state.step == 1 and loss_err <= ATOL_LOSS
    grads = ref["grads"]
    assert not [n for n, p in state.params.items() if p.grad is None]
    gaps = {n: max_err(p.grad, grads[n]) for n, p in state.params.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{case} step: gradient gap summed over {len(gaps)} leaves "
          f"{sum(gaps.values()):.3e}, worst {worst} {gaps[worst]:.2e}")
    assert sum(gaps.values()) <= ATOL_LEAF_SUM and gaps[worst] <= ATOL_LEAF
    # negative controls: a skipped backward, every gradient of the wrong
    # sign, or any one leaf zeroed or negated breaks these bounds, but for
    # the leaves whose JAX gradient lies within the leaf bound: the biases
    # of convs that feed a norm, which cancels them (0 up to rounding)
    sizes = {n: float(g.abs().max()) for n, g in grads.items()}
    dead = {n for n, v in sizes.items() if v <= ATOL_LEAF}
    assert all(n.endswith("bias") and sizes[n] <= 1e-5 for n in dead), sorted(dead)
    assert sum(sizes.values()) > ATOL_LEAF_SUM and len(dead) < len(sizes) // 4
    if ref["cfg"].get("activation", "prelu") == "prelu":
        assert any(n.endswith(".slope") for n in grads)
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref["new"][n].numpy(),
                                   rtol=RTOL_STEP, atol=ATOL_STEP, err_msg=n)
    for n, b in state.buffers.items():
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), ref["new"][n].numpy(), rtol=0,
                                   atol=ATOL_STATS, err_msg=n)
        assert not torch.equal(b, start[n]), n
    # the eval path on JAX's updated parameters and statistics: the
    # parameters themselves may differ by the W5 bound, ~lr where a
    # gradient is near zero
    trainer.restore(state, {"params": ref["new"]})
    with torch.no_grad():
        logits = trainer.make_inferer()(t(ref["batch"]["image"]), t(ref["batch"]["modality"]))
    err = max_err(logits, ref["logits"])
    print(f"{case} eval logits after the step: max |port - jax| = {err:.3e} "
          f"(|logits| <= {np.abs(ref['logits']).max():.2f})")
    assert err <= ATOL_MODEL


def test_prelu_slope_gradient_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 5, 5, 3)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    slope = np.array([0.3], np.float32)

    def jloss(a, xx):
        return jnp.sum(JPReLU().apply({"params": {"slope": a}}, xx) * g)

    want_a, want_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(slope), jnp.asarray(x))
    act = PReLU(device="cpu")
    act.init_parameters()
    assert float(act.slope.detach()) == 0.25
    act.slope.data.fill_(0.3)
    xt = t(x).requires_grad_(True)
    (act(xt) * t(g)).sum().backward()
    assert max_err(act.slope.grad, want_a) <= 1e-4 * (1 + float(np.abs(want_a).max()))
    assert max_err(xt.grad, want_x) <= 1e-6


# -------------------------------------------------------------- CLI ------

@pytest.fixture(scope="module")
def vanilla_run(tmp_path_factory):
    """One epoch of a synthetic 8-class CT + MR set through `cli.train
    --model_name unet_vanilla` (batch-norm decoder) on the CPU."""
    tmp = tmp_path_factory.mktemp("vanilla")
    data = tmp / "data"
    make_synthetic_dataset(data, shape=(24, 24, 24), num_classes=8, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=7)
    argv = ["--model_name", "unet_vanilla", "--out_channels", "8",
            "--feature_size", "4", "8", "8", "16", "16", "--strides", "1", "2", "2", "2", "1",
            "--num_res_units", "3", "--roi_x", "16", "--roi_y", "16", "--roi_z", "16",
            "--encoder_norm_name", "instance_cond", "--decoder_norm_name", "batch",
            "--no_amp", "--precision", "fp32", "--max_epochs", "1", "--num_workers", "0",
            "--cache_num", "2", "--scheduler", "none", "--data_dirs", str(data), str(data),
            "--json_lists", "CT.json", "MR.json", "--default_root_dir", str(tmp),
            "--experiment_name", "run", "--device", "cpu"]
    cfg, device = parse_args(argv)
    assert (cfg.model_name, cfg.feature_size, cfg.strides, cfg.num_res_units, device) == (
        "unet_vanilla", [4, 8, 8, 16, 16], [1, 2, 2, 2, 1], 3, "cpu")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["train", *argv])
        trainer, state, metrics = cli_train.main()
    finally:
        mp.undo()
    return dict(tmp=tmp, argv=argv, cfg=cfg, trainer=trainer, state=state, metrics=metrics)


def test_cli_train_unet_vanilla_then_cli_test(vanilla_run, monkeypatch):
    """The run took its 2 steps and saved its running statistics; `cli.test`
    on its best.ckpt reports what the run's own test did."""
    trainer, state, metrics = (vanilla_run[k] for k in ("trainer", "state", "metrics"))
    assert isinstance(trainer.model, UNetVanilla) and state.step == 2
    assert len(state.buffers) == 2 * 8 and all(
        not torch.equal(b, torch.zeros_like(b)) for n, b in state.buffers.items()
        if n.endswith(".mean"))
    assert all(np.isfinite(metrics[k]) for k in metrics if "dice" in k and "avg" in k)
    run = vanilla_run["tmp"] / "run"
    saved = ckpt.load_checkpoint(run / "last.ckpt")["params"]
    assert saved.keys() == trainer.model.state_dict().keys()
    assert all(torch.equal(saved[n], b) for n, b in state.buffers.items())
    monkeypatch.setattr(sys, "argv", ["test", *vanilla_run["argv"], "--ckpt_path",
                                      str(run / "best.ckpt")])
    assert cli_test.main() == metrics


def test_unet_vanilla_export_serve_and_predict_whs(vanilla_run):
    """best.ckpt through `cli.export` in f32 (the bundle's forward equals the
    live model) and bf16 (parameters bf16, running statistics f32 and
    exact), the HTTP server over the f32 bundle (a scan's answer in its
    own grid) and `cli.predict_whs` (MM-WHS label values in the scan's
    grid)."""
    tmp, cfg = vanilla_run["tmp"], vanilla_run["cfg"]
    best = ckpt.load_checkpoint(tmp / "run" / "best.ckpt")["params"]
    stats = {n: v for n, v in best.items() if n.endswith((".mean", ".var"))}
    assert len(stats) == 16
    cfg = cfg.replace(ckpt_path=str(tmp / "run" / "best.ckpt"), export_check=True,
                      export_dir=str(tmp / "bundle"))
    served = load_bundle(export.main(cfg, device="cpu"), device="cpu")
    live = model_from_config(cfg, device="cpu")
    live.load_state_dict(best)
    x = np.random.default_rng(2).random((1, 16, 16, 16, 1), np.float32)
    mods = np.array([1], np.int32)
    with torch.inference_mode():
        want = live(t(x), t(mods)).numpy()
    assert np.abs(served(x, mods).numpy() - want).max() <= 1e-6

    # (the export check's 2e-2 bounds an f32 bundle; a bf16 one's batch
    # norms are held norm by norm in the test below)
    bf16 = cfg.replace(no_amp=False, precision="bf16", export_dir=str(tmp / "bundle16"),
                       export_check=False)
    weights_bf16 = torch.load(f"{export.main(bf16, device='cpu')}/weights.pt",
                              weights_only=True)
    for n, v in weights_bf16.items():
        assert v.dtype == (torch.float32 if n in stats else torch.bfloat16), n
    assert all(torch.equal(weights_bf16[n], v) for n, v in stats.items())

    (tmp / "ct").mkdir()
    scan = write_scan(tmp / "ct" / "a_image.nii.gz", (30, 26, 20), (1.3, 1.1, 1.6), seed=5,
                      dtype=np.int16)
    native = load_nifti(scan)
    server = cli_serve.make_server(str(tmp / "bundle"), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, _, body = post(f"http://127.0.0.1:{server.server_port}/predict?modality=0",
                               scan.read_bytes())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    answer = as_nifti(tmp, body)
    assert status == 200 and answer.data.shape == native.data.shape
    assert np.array_equal(answer.affine, native.affine)
    assert set(np.unique(answer.data).tolist()) <= set(range(8))

    (tmp / "CT_test.json").write_text(json.dumps({"modality": 0,
                                                  "test": ["ct/a_image.nii.gz"]}))
    written = predict_whs.main(cfg, data_dir=str(tmp), json_list="CT_test.json",
                               result_dir=str(tmp / "out"), device="cpu")
    assert len(written) == 1
    label = load_nifti(written[0])
    assert label.data.dtype == np.uint16 and label.data.shape == native.data.shape
    assert np.array_equal(label.affine, native.affine)
    assert set(np.unique(label.data).tolist()) <= {0, *predict_whs.MMWHS_LABEL_MAP.values()}


def test_bf16_batch_norm_bundle_uses_its_f32_statistics(vanilla_run):
    """A bf16 bundle of the batch-norm run's best.ckpt, one window: every
    batch norm of the forward gives, from its bf16 input, its f32 running
    statistics and its bf16 scale and bias, the exact answer rounded once
    to bf16 (within half a bf16 ulp, 2^-8 relative, and the f32 rounding of
    its terms).  The answer from fresh statistics (mean 0, var 1, what the
    reference's bundles would hold: W9) or from statistics rounded to
    bf16 breaks that bound.  The bundle's exported program has no modules
    to hook: the norms are read in the model rebuilt from the bundle's
    weights, whose logits must equal the served program's.  The logits are
    reported beside the f32 bundle's."""
    tmp, cfg = vanilla_run["tmp"], vanilla_run["cfg"]
    best = ckpt.load_checkpoint(tmp / "run" / "best.ckpt")["params"]
    out = {}
    for precision in ("fp32", "bf16"):
        c = cfg.replace(ckpt_path=str(tmp / "run" / "best.ckpt"), no_amp=precision == "fp32",
                        precision=precision, export_dir=str(tmp / f"bn_{precision}"))
        out[precision] = load_bundle(export.main(c, device="cpu"), device="cpu")
    served = out["bf16"]
    rebuilt = model_from_config(c, device="cpu", dtype=torch.bfloat16)
    rebuilt.load_state_dict(served.state_dict(), strict=True)
    seen = []
    for name, m in rebuilt.named_modules():
        if isinstance(m, Norm) and m.kind == "batch":
            m.register_forward_hook(
                lambda mod, args, kw, y, name=name: seen.append((name, args[0], kw, y)),
                with_kwargs=True)
    x = np.random.default_rng(3).random((1, 16, 16, 16, 1), np.float32)
    mods = np.array([0], np.int32)
    logits = served(x, mods)
    with torch.inference_mode():
        again = rebuilt(torch.from_numpy(x).bfloat16(), torch.from_numpy(mods)).float()
    print(f"served program vs rebuilt model: max |diff| {float((logits - again).abs().max())}")
    assert torch.equal(logits, again)
    assert len(seen) == 8 and np.isfinite(logits.numpy()).all()
    worst = {}
    for name, xin, kw, y in seen:
        assert xin.dtype == y.dtype == torch.bfloat16 and not kw, name
        norm = rebuilt.get_submodule(name)
        scale, bias = norm.scale.detach().double(), norm.bias.detach().double()
        mean, var = best[f"{name}.mean"].double(), best[f"{name}.var"].double()
        for label, (mu, v) in {
                "f32": (mean, var), "fresh": (torch.zeros_like(mean), torch.ones_like(var)),
                "bf16": (mean.bfloat16().double(), var.bfloat16().double())}.items():
            z = (xin.double() - mu) / torch.sqrt(v + 1e-5) * scale
            want = z + bias
            bound = 2.0 ** -8 * want.abs() + 1e-6 * (z.abs() + bias.abs())
            excess = float(((y.double() - want).abs() - bound).max())
            worst[label] = max(worst.get(label, -np.inf), excess)
    print(f"bf16 batch norms: largest |y - exact| beyond the bound, by the statistics "
          f"the exact answer takes: {worst}; logits max |bf16 - f32 bundle| "
          f"{float((logits - out['fp32'](x, mods)).abs().max()):.3e}")
    assert worst["f32"] <= 0.0 < worst["bf16"] and worst["fresh"] > 0.0
