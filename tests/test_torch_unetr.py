"""The port's C-UNETR against the JAX package (CPU, f32).

* Whole-model logits through `model_from_config` (`unetr`, fs 16, 32^3
  ROI, 4 classes, `instance_cond` encoder and ViT norms, `instance`
  decoder norms, the Config's `perceptron` patchify) on bridged weights,
  on both of the port's conv-block paths, at two ViT widths: hidden 96
  with 12 heads of 8 and mlp 192 at batch 2 (modalities [0, 1]), and the
  full width, hidden 768, mlp 3072, 12 heads, at batch 1.  atol 2e-4, as
  tests/test_torch_model.py holds the flagship.
* The weight bridge on UNETR's tree: strict loading; UnetrPrUpBlock's
  transposed convs, among them encoder2's `up0` with as many input as
  output channels, compute JAX's output; the old name rule (`transp_conv`
  alone) as a negative control; swin_unetr's bridged state dict unchanged.
* One `Trainer.train_step` of the narrow model against JAX's: the loss
  within 1e-4, the parameters after the AdamW step within the W5 bound
  (rtol 1e-4 / atol 2.5e-4).
* `cli.train --model_name unetr` for one epoch of a synthetic set, whose
  best.ckpt `cli.test` evaluates; `cli.export` of a checkpoint, the HTTP
  server over the bundle and `cli.predict_whs`, each with the narrow
  model.
"""

import functools
import json
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
from miseg_tpu.models.unetr import UNETR as JUNETR
from miseg_tpu.nn.dynunet import _conv as j_conv
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch import weights
from miseg_tpu_torch.cli import export, parse_args, predict_whs
from miseg_tpu_torch.cli import serve as cli_serve
from miseg_tpu_torch.cli import test as cli_test
from miseg_tpu_torch.cli import train as cli_train
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.nifti import load_nifti
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.models import UNETR, model_from_config
from miseg_tpu_torch.serve import load_bundle
from miseg_tpu_torch.train import checkpoint as ckpt
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_MODEL = 2e-4
ATOL_BLOCK = 1e-5
ATOL_LOSS = 1e-4
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
_CFG = dict(model_name="unetr", out_channels=4, feature_size=[16], roi_x=32, roi_y=32,
            roi_z=32, encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
            decoder_norm_name="instance")
# (hidden, mlp, heads, batch): the narrow ViT and the full width
_WIDTHS = {"narrow": (96, 192, 12, 2), "full": (768, 3072, 12, 1)}


def _cfg(width: str, **kw) -> dict:
    hidden, mlp, heads, _ = _WIDTHS[width]
    return dict(_CFG, hidden_size=hidden, mlp_dim=mlp, num_heads=heads, **kw)


@functools.lru_cache(maxsize=None)
def _jax_model(width: str):
    """(x, modalities, params, JAX logits) of the width's model, once per
    worker."""
    batch = _WIDTHS[width][3]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((batch, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([0, 1][:batch], np.int32)
    jmodel = jax_model_from_config(JConfig(**_cfg(width)))
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    # jitted: eager flax apply of the whole model is several times slower
    forward = jax.jit(lambda p, a, m: jmodel.apply({"params": p}, a, m))
    want = np.asarray(forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                              jnp.asarray(mods)))
    return x, mods, params, want


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("fused_conv", [True, False])
def test_unetr_matches_jax(width, fused_conv):
    x, mods, params, want = _jax_model(width)
    model = model_from_config(Config(**_cfg(width)), device="cpu", fused_conv=fused_conv)
    assert isinstance(model, UNETR)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(t(x), t(mods))
    err = max_err(got, want)
    print(f"unetr {width} 32^3 f32 fused_conv={fused_conv} logits max |port - jax| = "
          f"{err:.3e} (|logits| <= {np.abs(want).max():.2f})")
    assert np.isfinite(got.numpy()).all()
    assert err <= ATOL_MODEL


def test_unetr_checks_and_encoder_prefixes():
    assert UNETR.ENCODER_PREFIXES == JUNETR.ENCODER_PREFIXES
    with pytest.raises(ValueError, match="Layer normalization"):
        model_from_config(Config(**_cfg("narrow", encoder_norm_name="layer")), device="cpu")
    model = model_from_config(Config(**_cfg("narrow")), device="cpu")
    with pytest.raises(ValueError, match="Modalities"):
        model(torch.zeros((1, 32, 32, 32, 1)))
    with pytest.raises(ValueError, match="num_layers"):
        UNETR(1, 4, (32, 32, 32), hidden_size=96, mlp_dim=192, num_layers=6, device="cpu")


# ---------------------------------------------------------- the bridge ----

def _old_rule(monkeypatch):
    """The bridge as it was before UnetrPrUpBlock: only a `transp_conv`
    module's kernel is a transposed conv's."""
    monkeypatch.setattr(weights, "_is_transposed", lambda module: module == "transp_conv")


def test_bridge_transposes_unetr_pr_up_kernels(monkeypatch):
    """encoder2's `up0` (32 -> 32) on its own computes JAX's output under the
    bridge; under the old name rule its kernel has the right shape, loads,
    and computes something else, and the whole tree no longer loads."""
    _, _, params, _ = _jax_model("narrow")
    kernel = params["encoder2"]["up0"]["kernel"]
    assert kernel.shape == (2, 2, 2, 32, 32)
    model = model_from_config(Config(**_cfg("narrow")), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    y = np.random.default_rng(4).standard_normal((2, 4, 5, 6, 32)).astype(np.float32)
    want = j_conv(32, 2, 2, transposed=True).apply({"params": params["encoder2"]["up0"]},
                                                  jnp.asarray(y))
    with torch.no_grad():
        got = model.encoder2.up0(t(y))
    assert max_err(got, want) <= ATOL_BLOCK

    _old_rule(monkeypatch)
    old = state_dict_from_jax(params)
    up0 = model_from_config(Config(**_cfg("narrow")), device="cpu").encoder2.up0
    up0.load_state_dict({"weight": old["encoder2.up0.weight"]}, strict=True)
    with torch.no_grad():
        wrong = up0(t(y))
    assert max_err(wrong, want) > 0.1
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(old, strict=True)


def test_bridge_keeps_swin_unetr_unchanged(monkeypatch):
    """swin_unetr's bridged keys, shapes and values are those of the old
    name rule."""
    cfg = dict(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
               roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
               vit_norm_name="instance_cond", decoder_norm_name="instance")
    params = seeded_params(jax_model_from_config(JConfig(**cfg)), jnp.zeros((1, 32, 32, 32, 1)),
                           jnp.zeros((1,), jnp.int32))
    new = state_dict_from_jax(params)
    _old_rule(monkeypatch)
    old = state_dict_from_jax(params)
    assert len(new) == 203 and new.keys() == old.keys()
    assert all(torch.equal(new[k], old[k]) for k in new)


# ---------------------------------------------------------- one step -----

_STEP = dict(criterion="dice_focal", optim_name="adamw", lr=1e-4, reg_weight=1e-5,
             no_amp=True)


@pytest.fixture(scope="module")
def jax_step():
    """What JAX's train step computes for the narrow model: the loss of
    `jax.jit(jax.value_and_grad)` and the parameters after one AdamW
    update."""
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    label = rng.integers(0, 4, (2, 32, 32, 32)).astype(np.int32)
    mods = np.array([0, 1], np.int32)
    jcfg = JConfig(**_cfg("narrow", **_STEP))
    jmodel = jax_model_from_config(jcfg)
    params = seeded_params(jmodel, jnp.asarray(image), jnp.asarray(mods))
    loss_fn = JL.loss_from_config(jcfg)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, image, mods, train=True)
        return loss_fn(logits.astype(jnp.float32), label)

    jparams = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(jparams)
    tx = j_optimizer_from_config(jcfg)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, jparams)
    return dict(batch={"image": image, "label": label[..., None], "modality": mods},
                params=params, loss=float(loss),
                new=state_dict_from_jax(jax.tree.map(np.array, new)))


def test_train_step_matches_jax(jax_step):
    trainer = engine.Trainer(Config(**_cfg("narrow", **_STEP)), device="cpu")
    state = trainer.init_state(state_dict_from_jax(jax_step["params"]))
    state, loss = trainer.train_step(state, jax_step["batch"])
    loss_err = abs(float(loss) - jax_step["loss"])
    print(f"unetr narrow step: loss {float(loss):.6f} |diff| {loss_err:.2e}")
    assert state.step == 1 and loss_err <= ATOL_LOSS
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in state.params.values())
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_step["new"][n].numpy(),
                                   rtol=RTOL_STEP, atol=ATOL_STEP, err_msg=n)


# -------------------------------------------------------------- CLI ------

def test_cli_train_unetr_then_cli_test(tmp_path, monkeypatch):
    """One epoch of a synthetic CT + MR set through `cli.train --model_name
    unetr` on the CPU; `cli.test` reads the run's best.ckpt and reports what
    the run's own test did."""
    data = tmp_path / "data"
    make_synthetic_dataset(data, shape=(32, 32, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=7)
    argv = ["--model_name", "unetr", "--out_channels", "4", "--feature_size", "16",
            "--hidden_size", "96", "--mlp_dim", "192", "--num_heads", "12",
            "--roi_x", "32", "--roi_y", "32", "--roi_z", "32",
            "--encoder_norm_name", "instance_cond", "--vit_norm_name", "instance_cond",
            "--no_amp", "--precision", "fp32", "--max_epochs", "1", "--num_workers", "0",
            "--cache_num", "2", "--scheduler", "none", "--data_dirs", str(data), str(data),
            "--json_lists", "CT.json", "MR.json", "--default_root_dir", str(tmp_path),
            "--experiment_name", "run", "--device", "cpu"]
    cfg, device = parse_args(argv)
    assert (cfg.model_name, cfg.hidden_size, cfg.pos_embed, device) == (
        "unetr", 96, "perceptron", "cpu")
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    trainer, state, metrics = cli_train.main()
    assert isinstance(trainer.model, UNETR) and state.step == 2
    assert all(np.isfinite(metrics[k]) for k in metrics if "dice" in k and "avg" in k)
    run = tmp_path / "run"
    assert (run / "best.ckpt").exists() and (run / "last.ckpt").exists()
    monkeypatch.setattr(sys, "argv", ["test", *argv, "--ckpt_path", str(run / "best.ckpt")])
    assert cli_test.main() == metrics


def test_unetr_export_serve_and_predict_whs(tmp_path):
    """The narrow model's port checkpoint through `cli.export` (the bundle's
    forward equals the live model), the HTTP server over that bundle (a
    scan's answer in the scan's own grid) and `cli.predict_whs` (a label
    file per test scan, in its grid)."""
    _, _, params, _ = _jax_model("narrow")
    path = tmp_path / "best.pt"
    ckpt.save_checkpoint(path, params=state_dict_from_jax(params))
    cfg = Config(**_cfg("narrow", no_amp=True, precision="fp32"), ckpt_path=str(path),
                 export_dir=str(tmp_path / "bundle"), export_check=True)
    served = load_bundle(export.main(cfg, device="cpu"), device="cpu")
    live = model_from_config(cfg, device="cpu")
    live.load_state_dict(state_dict_from_jax(params))
    x = np.random.default_rng(2).random((1, 32, 32, 32, 1), np.float32)
    mods = np.array([1], np.int32)
    with torch.inference_mode():
        want = live(t(x), t(mods)).numpy()
    assert np.abs(served(x, mods).numpy() - want).max() <= 1e-6

    (tmp_path / "ct").mkdir()
    scan = write_scan(tmp_path / "ct" / "a_image.nii.gz", (30, 26, 20), (1.3, 1.1, 1.6),
                      seed=5, dtype=np.int16)
    native = load_nifti(scan)
    server = cli_serve.make_server(str(tmp_path / "bundle"), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, _, body = post(f"http://127.0.0.1:{server.server_port}/predict?modality=0",
                               scan.read_bytes())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    answer = as_nifti(tmp_path, body)
    assert status == 200 and answer.data.shape == native.data.shape
    assert np.array_equal(answer.affine, native.affine)
    assert set(np.unique(answer.data).tolist()) <= set(range(4))

    (tmp_path / "CT_test.json").write_text(json.dumps(
        {"modality": 0, "test": ["ct/a_image.nii.gz"]}))
    written = predict_whs.main(cfg, data_dir=str(tmp_path), json_list="CT_test.json",
                               result_dir=str(tmp_path / "out"), device="cpu")
    assert len(written) == 1
    label = load_nifti(written[0])
    assert label.data.shape == native.data.shape
    assert np.array_equal(label.affine, native.affine)
