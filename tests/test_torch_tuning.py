"""Host stitching, the progress line, the batch-size tuner and the
learning-rate sweep, in the port against the JAX package (CPU, f32).

* `infer_cpu`: a 40 x 36 x 20 volume (no multiple of the 16^3 ROI,
  gaussian blend, overlap 0.5, sw_batch_size 2) through the trainer's
  inferer stitching in host memory equals JAX's `stitch_on_host=True`
  within 2e-4 and the port's own device stitch within 1e-5; the
  `infer_progress` line equals the one JAX prints.
* `scale_batch_size`: a trial that runs out of memory at batch 4 gives 2
  (PyTorch's `OutOfMemoryError` and JAX's marker strings alike); any
  other error re-raises; a first trial that does not fit raises JAX's
  RuntimeError; real trials on the CPU (fresh trainers) double as far
  as `max_trials` allows.
* `lr_find` against JAX's `lr_find` from the same weights (a JAX msgpack
  checkpoint as `--pretrained` for both) on the same synthetic data:
  identical lrs, losses within 1e-4 while lr <= 1e-3.  Beyond that,
  AdamW turns f32 noise in near-zero gradients into lr-sized parameter
  gaps (ROADMAP W7), so only finiteness and the same early stop are
  held there.  `find_best_lr.main` writes its files.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params

from miseg_tpu.cli import find_best_lr as jax_find_best_lr
from miseg_tpu.config import Config as JConfig
from miseg_tpu.inferers import SlidingWindowInferer as JInferer
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train import tuner as jax_tuner
from miseg_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from miseg_tpu_torch.cli import find_best_lr
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.train import engine, tuner
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_JAX = 2e-4
ATOL_SELF = 1e-5
ATOL_LOSS = 1e-4
UNET = dict(model_name="unet", out_channels=4, feature_size=[4], roi_x=16, roi_y=16,
            roi_z=16, encoder_norm_name="instance_cond", decoder_norm_name="instance",
            no_amp=True, precision="fp32", infer_overlap=0.5, sw_batch_size=2)


@pytest.fixture(scope="module")
def unet():
    """(JAX model, seeded params, a 40 x 36 x 20 volume, its modalities)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 40, 36, 20, 1)).astype(np.float32)
    mods = np.array([1], np.int32)
    jmodel = jax_model_from_config(JConfig(**UNET))
    params = seeded_params(jmodel, jnp.zeros((1, 16, 16, 16, 1)), jnp.zeros((1,), jnp.int32),
                           seed=22)
    return jmodel, params, x, mods


def _port_inferer(params, **kw):
    trainer = engine.Trainer(Config(**UNET, **kw), device="cpu")
    trainer.init_state(state_dict_from_jax(params))
    return trainer.make_inferer("gaussian")


def test_host_stitching_matches_jax_and_the_device_stitch(unet):
    jmodel, params, x, mods = unet
    jinf = JInferer(lambda w, m: jmodel.apply({"params": params}, w, m), roi_size=(16,) * 3,
                    sw_batch_size=2, overlap=0.5, mode="gaussian", out_channels=4,
                    stitch_on_host=True)
    want = np.asarray(jinf(jnp.asarray(x), jnp.asarray(mods)))
    host = _port_inferer(params, infer_cpu=True)
    assert host.stitch_on_host
    got = host(torch.from_numpy(x), torch.from_numpy(mods))
    device = _port_inferer(params)(torch.from_numpy(x), torch.from_numpy(mods))
    assert got.shape == device.shape == (1, 40, 36, 20, 4)
    err_jax, err_self = max_err(got, want), max_err(got, device)
    print(f"infer_cpu: max |port - jax stitch_on_host| {err_jax:.2e}, "
          f"|host - device stitch| {err_self:.2e}")
    assert err_jax <= ATOL_JAX and err_self <= ATOL_SELF


def test_progress_line_is_jaxs(unet, capsys):
    jmodel, params, x, mods = unet
    jinf = JInferer(lambda w, m: jmodel.apply({"params": params}, w, m), roi_size=(16,) * 3,
                    sw_batch_size=2, overlap=0.5, mode="gaussian", out_channels=4,
                    progress=True)
    jax.block_until_ready(jinf(jnp.asarray(x), jnp.asarray(mods)))
    jax.effects_barrier()
    want = capsys.readouterr().err
    _port_inferer(params, infer_progress=True)(torch.from_numpy(x), torch.from_numpy(mods))
    got = capsys.readouterr().err
    assert got == want and got.endswith("\n") and "[sliding-window] 1/" in got
    print(repr(got))


# ------------------------------------------------------------- tuner ----

def _oom_at(limit: int, error):
    tried = []

    def step(cfg, batch_size):
        tried.append(batch_size)
        if batch_size >= limit:
            raise error
    return step, tried


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("CUDA out of memory."),
                                   RuntimeError("RESOURCE_EXHAUSTED: while allocating")])
def test_scale_batch_size_backs_off(error):
    cfg = Config(**UNET)
    step, tried = _oom_at(4, error)
    assert tuner.scale_batch_size(cfg, step_fn=step, verbose=False) == 2
    assert tried == [1, 2, 4]
    jstep, jtried = _oom_at(4, error)
    assert jax_tuner.scale_batch_size(JConfig(**UNET), step_fn=jstep, verbose=False) == 2
    assert jtried == tried
    assert tuner.is_oom_error(error) and jax_tuner.is_oom_error(error)


def test_scale_batch_size_reraises_and_fails_like_jax():
    cfg = Config(**UNET)
    step, _ = _oom_at(2, ValueError("a shape bug"))
    with pytest.raises(ValueError, match="a shape bug"):
        tuner.scale_batch_size(cfg, step_fn=step, verbose=False)
    step, _ = _oom_at(1, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    jstep, _ = _oom_at(1, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    with pytest.raises(RuntimeError) as ours:
        tuner.scale_batch_size(cfg, step_fn=step, verbose=False)
    with pytest.raises(RuntimeError) as theirs:
        jax_tuner.scale_batch_size(JConfig(**UNET), step_fn=jstep, verbose=False)
    assert str(ours.value) == str(theirs.value)
    assert not tuner.is_oom_error(ValueError("a shape bug"))


def test_scale_batch_size_runs_real_trials(capsys):
    """Real steps on fresh trainers (no out-of-memory on the CPU: the
    doubling stops at `max_trials`)."""
    cfg = Config(**UNET)
    assert tuner.scale_batch_size(cfg, max_trials=2, device="cpu") == 2
    assert capsys.readouterr().out.splitlines() == ["batch_size=1 fits", "batch_size=2 fits"]


# -------------------------------------------------------------- lr sweep ----

@pytest.fixture(scope="module")
def sweep_setup(tmp_path_factory, unet):
    root = tmp_path_factory.mktemp("lrdata")
    make_synthetic_dataset(root, shape=(24, 24, 20), num_classes=4, n_train=2, n_val=1,
                           n_test=0, spacing=(1.0, 1.0, 1.0), seed=23)
    start = root / "start.ckpt"
    jax_save_checkpoint(start, params=unet[1])
    cfg = dict(UNET, data_dirs=[str(root)] * 2, json_lists=["CT.json", "MR.json"],
               pretrained=str(start), batch_size=1, patches_training_sample=1,
               num_workers=0, cache_num=4, optim_name="adamw", lr=1e-4,
               min_lr=1e-5, max_lr=5e-3, default_root_dir=str(root / "runs"))
    return cfg


def test_lr_find_matches_jax(sweep_setup):
    kw = dict(num_steps=8, min_lr=1e-5, max_lr=5e-3)
    want = jax_find_best_lr.lr_find(JConfig(**sweep_setup), **kw)
    got = find_best_lr.lr_find(Config(**sweep_setup), device="cpu", **kw)
    assert got["lrs"] == want["lrs"] and len(got["lrs"]) == 8
    early = [i for i, lr in enumerate(got["lrs"]) if lr <= 1e-3]
    gaps = [abs(got["losses"][i] - want["losses"][i]) for i in early]
    print(f"lr_find: {len(early)} steps at lr <= 1e-3, loss gaps {', '.join(f'{g:.1e}' for g in gaps)}; "
          f"suggestions port {got['lr']:.3e}, jax {want['lr']:.3e}")
    assert len(early) >= 6 and max(gaps) <= ATOL_LOSS
    assert all(np.isfinite(got["losses"]))
    assert 1e-5 <= got["lr"] <= 5e-3


def test_find_best_lr_main_writes_its_files(sweep_setup):
    cfg = Config(**sweep_setup)
    result = find_best_lr.main(cfg, device="cpu", num_steps=4)
    out = Path(cfg.default_root_dir) / "lr_find"
    args = json.loads((out / "args.json").read_text())
    curve = json.loads((out / "curve.json").read_text())
    assert args == {"suggested_lr": result["lr"], "model": "unet"}
    assert curve == {"lrs": result["lrs"], "losses": result["losses"]}
    assert len(curve["lrs"]) == 4 and cfg.min_lr <= result["lr"] <= cfg.max_lr
