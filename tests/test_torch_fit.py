"""The port's trainer (`train/engine.py` `fit`/`evaluate`, `schedules.py`,
`optim.py`, `checkpoint.CheckpointManager`, dropout, `cli/train.py`,
`cli/test.py`) against the JAX package's, on the CPU, f32.

* A whole `fit` + `evaluate` of the fs-12 C-Swin-UNETR (heads 2, 32^3
  ROI, dropout 0) on a synthetic CT + MR set (1 train / 1 val / 1 test
  volume a modality, 2 epochs, lr 1e-3), both packages started from the
  same parameters (`weights.state_dict_from_jax`):
  - AdamW: every step's loss within 1e-4 of JAX's, and a run with the
    optimizer step skipped more than 1e-4 away (the negative control);
    the val metric keys equal and the val loss within 1e-4; the port's
    `evaluate` of JAX's final parameters within 1e-3 of JAX's Dice; the
    same checkpoint files (epoch for epoch, each named by its own run's
    val accuracy) and the same keys in every `metrics.jsonl` line.  The
    two fits' Dice are not held to each other: AdamW's first steps move
    an element by about lr whatever its gradient's size, so f32
    summation-order differences in near-zero gradients become parameter
    differences of ~1e-3 (measured: worst 5.1e-3 after 4 steps), and the
    barely trained net's argmax flips near ties (Dice up to 2.8e-3 apart).
  - SGD (lr 1e-2): the same (but the control), and also the two fits'
    val Dice within 1e-3 and identical checkpoint file names.
* Resume equals an uninterrupted run (exactly, on the CPU): the losses,
  step counter (and the dropout stream), AdamW state, parameters, lr and
  plateau state.
* Schedules (equal floats), learning-rate injection, the encoder freeze
  and gradient accumulation with its epoch-end flush against optax
  (rtol 1e-6, atol 1e-7: a few f32 ulps of parameters of size ~1),
  early stopping against JAX's.
* Dropout: nothing changes at rate 0; at rate p the drop-path mask is per
  sample, kept values scale by 1/(1-p), eval mode drops nothing, and the
  same (seed, step) repeats the loss.  The RNGs differ from JAX's, so
  these are statistical checks, not parity.
* `make_inferer`/`evaluate` run eval mode on one cast of the masters a
  call, with no autograd Function; `cli.train.main` and `cli.test.main`
  run from a command line on the CPU.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from test_torch_bridge import seeded_params

from miseg_tpu.config import Config as JConfig
from miseg_tpu.data.multi_modal import MultiModalData as JData
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train import optim as joptim
from miseg_tpu.train import schedules as jsched
from miseg_tpu.train.engine import EarlyStopping as JEarlyStopping
from miseg_tpu.train.engine import Trainer as JTrainer
from miseg_tpu.utils.logging import MetricLogger as JLogger
from miseg_tpu_torch.cli import parse_args
from miseg_tpu_torch.cli import test as cli_test
from miseg_tpu_torch.cli import train as cli_train
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.multi_modal import MultiModalData
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.nn import dropout
from miseg_tpu_torch.nn import swin as port_swin
from miseg_tpu_torch.nn.dynunet import UnetResBlock, _fuse_plan
from miseg_tpu_torch.train import engine, optim, schedules, tuner
from miseg_tpu_torch.train.checkpoint import load_checkpoint
from miseg_tpu_torch.utils.logging import MetricLogger
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_STEP_LOSS = 1e-4
ATOL_VAL_LOSS = 1e-4
ATOL_DICE = 1e-3
ATOL_OPT, RTOL_OPT = 1e-7, 1e-6   # a few f32 ulps of parameters ~1
CFG = dict(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
           depth_swin_block=[2], roi_x=32, roi_y=32, roi_z=32,
           encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
           decoder_norm_name="instance", no_amp=True, precision="fp32", lr=1e-3,
           criterion="dice_focal", max_epochs=2, check_val_every_n_epoch=1, batch_size=1,
           patches_training_sample=1, scheduler="none", cache_num=4, num_workers=0,
           patience=10, seed=0, json_lists=["CT.json", "MR.json"])
FITS = {"adamw": dict(optim_name="adamw", lr=1e-3), "sgd": dict(optim_name="sgd", lr=1e-2)}


def _config(cls, root, **kw):
    return cls(**{**CFG, "data_dirs": [str(root)] * 2, **kw})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """40 x 36 x 32 volumes at 1.0 mm: random 32^3 crops, 8 windows a
    validation volume."""
    root = tmp_path_factory.mktemp("fitdata")
    make_synthetic_dataset(root, shape=(40, 36, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=5)
    return root


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """32^3 volumes: one window each, for the runs held to the port itself."""
    root = tmp_path_factory.mktemp("smalldata")
    make_synthetic_dataset(root, shape=(32, 32, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=6)
    return root


@pytest.fixture(scope="module")
def params():
    model = jax_model_from_config(JConfig(**{k: v for k, v in CFG.items()}))
    return seeded_params(model, jnp.zeros((1, 32, 32, 32, 1)), jnp.zeros((1,), jnp.int32),
                         seed=3)


def _record_losses(cls, sink):
    """Patch `cls.train_step` to append each step's loss to `sink`; returns
    the undo."""
    orig = cls.train_step

    def step(self, state, batch):
        state, loss = orig(self, state, batch)
        sink.append(float(loss))
        return state, loss

    cls.train_step = step
    return lambda: setattr(cls, "train_step", orig)


def _jsonl_keys(path):
    return [sorted(json.loads(line)) for line in open(path)]


def _last_val(path):
    return [json.loads(line) for line in open(path) if "val/loss/avg" in line][-1]


def _port_fit(root, params, workdir, skip_update=False, **kw):
    cfg = _config(Config, root, **kw)
    trainer = engine.Trainer(cfg, device="cpu", workdir=str(workdir),
                             logger=MetricLogger(workdir, quiet=True))
    state = trainer.init_state(state_dict_from_jax(params))
    if skip_update:
        state.optimizer.step = lambda *a, **k: None
    losses = []
    undo = _record_losses(engine.Trainer, losses)
    try:
        state = trainer.fit(MultiModalData(cfg), state=state)
    finally:
        undo()
    return trainer, state, losses


@pytest.fixture(scope="module", params=sorted(FITS))
def jax_fit(request, dataset, params, tmp_path_factory):
    """JAX's `Trainer.fit` on one device, started from `params`."""
    name = request.param
    workdir = tmp_path_factory.mktemp(f"jax_{name}")
    jcfg = _config(JConfig, dataset, **FITS[name])
    trainer = JTrainer(jcfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)),
                       workdir=str(workdir), logger=JLogger(workdir, quiet=True))
    state = trainer.init_state(np.zeros((1, 32, 32, 32, 1), np.float32),
                               np.zeros((1,), np.int32), params=params)
    losses = []
    undo = _record_losses(JTrainer, losses)
    try:
        state = trainer.fit(JData(jcfg), state=state)
    finally:
        undo()
    return dict(name=name, workdir=workdir, losses=losses, step=int(state.step),
                params=jax.tree.map(np.array, state.params))


def _ckpt_files(workdir):
    return sorted(p.name for p in (workdir / "checkpoints").iterdir())


def test_fit_matches_jax(jax_fit, dataset, params, tmp_path):
    name = jax_fit["name"]
    trainer, state, losses = _port_fit(dataset, params, tmp_path / "port", **FITS[name])
    diffs = np.abs(np.asarray(losses) - np.asarray(jax_fit["losses"]))
    print(f"{name}: step losses JAX {jax_fit['losses']} port {losses}; worst |diff| "
          f"{diffs.max():.2e}")
    assert len(losses) == len(jax_fit["losses"]) == 4
    assert state.step == jax_fit["step"] == 4
    assert diffs.max() <= ATOL_STEP_LOSS

    if name == "adamw":      # one epoch: its second step already sees no update
        _, _, frozen = _port_fit(dataset, params, tmp_path / "control", skip_update=True,
                                 max_epochs=1, **FITS[name])
        control = np.abs(np.asarray(frozen) - np.asarray(jax_fit["losses"][:2])).max()
        print(f"{name}: with the optimizer step skipped, worst |diff| {control:.2e}")
        assert control > ATOL_STEP_LOSS

    jdir, pdir = jax_fit["workdir"], tmp_path / "port"
    want, got = _last_val(jdir / "metrics.jsonl"), _last_val(pdir / "metrics.jsonl")
    assert sorted(got) == sorted(want)
    val_loss_err = max(abs(got[k] - want[k]) for k in want if "/loss/" in k)
    assert val_loss_err <= ATOL_VAL_LOSS
    dice = [k for k in want if "dice" in k or "accuracy" in k]
    fit_gap = max(abs(got[k] - want[k]) for k in dice if not np.isnan(want[k]))
    print(f"{name}: val loss |diff| {val_loss_err:.2e}; fit-to-fit Dice |diff| {fit_gap:.2e}")
    assert _jsonl_keys(pdir / "metrics.jsonl") == _jsonl_keys(jdir / "metrics.jsonl")

    # the port's evaluate of JAX's own final parameters against JAX's evaluate
    same = engine.Trainer(_config(Config, dataset, **FITS[name]), device="cpu",
                          workdir=str(tmp_path / "eval"),
                          logger=MetricLogger(tmp_path / "eval", quiet=True))
    on_jax = same.evaluate(MultiModalData(same.cfg).val_dataloader(),
                           same.init_state(state_dict_from_jax(jax_fit["params"])), epoch=1)
    assert sorted(on_jax) == sorted(k for k in want if k not in ("ts", "step"))
    eval_gap = max(abs(on_jax[k] - want[k]) for k in dice if not np.isnan(want[k]))
    print(f"{name}: evaluate of JAX's parameters, Dice |diff| {eval_gap:.2e}")
    assert eval_gap <= ATOL_DICE
    assert max(abs(on_jax[k] - want[k]) for k in want if "/loss/" in k) <= ATOL_VAL_LOSS

    jfiles, pfiles = _ckpt_files(jdir), _ckpt_files(pdir)
    assert len(jfiles) == len(pfiles) == 7
    for jf, pf in zip(jfiles, pfiles):
        assert jf.split("-")[0] == pf.split("-")[0]
    for d in (jdir, pdir):
        assert (d / "best.ckpt").exists() and (d / "last.ckpt").exists()
    lines = [json.loads(s) for s in open(pdir / "metrics.jsonl") if "val/loss/avg" in s]
    assert [f for f in pfiles if f.startswith("epoch") and f.endswith(".ckpt")] == [
        f"epoch{ln['step']:05d}-{ln['val/accuracy/avg']:.4f}.ckpt" for ln in lines]
    last = load_checkpoint(pdir / "last.ckpt")
    assert last["epoch"] == 1 and last["opt_state"]["gradient_step"] == 4
    if name == "sgd":
        assert fit_gap <= ATOL_DICE
        assert pfiles == jfiles


def test_resume_equals_an_uninterrupted_run(small_dataset, params, tmp_path):
    """1 epoch, resume from last.ckpt, 1 more epoch == 2 straight epochs,
    with dropout, drop-path and attention dropout on (the resumed step
    counter continues the dropout stream) and a plateau schedule that
    moves (patience 0)."""
    kw = dict(dropout_rate=0.1, dropout_path_rate=0.2, attn_drop_rate=0.1,
              scheduler="reduce_on_plateau", patience_scheduler=0)
    straight, s_state, s_losses = _port_fit(small_dataset, params, tmp_path / "straight", **kw)
    _, _, first = _port_fit(small_dataset, params, tmp_path / "a", max_epochs=1, **kw)
    resumed, r_state, second = _port_fit(small_dataset, params, tmp_path / "b",
                                         ckpt_path=str(tmp_path / "a" / "last.ckpt"), **kw)
    assert len(first) == len(second) == 2 and first + second == s_losses
    assert r_state.step == s_state.step == 4
    assert resumed.history["epoch_s"] and len(resumed.history["epoch_s"]) == 1
    for n, p in s_state.params.items():
        assert torch.equal(p, r_state.params[n]), n
    s_opt, r_opt = s_state.optimizer.state_dict(), r_state.optimizer.state_dict()
    assert s_opt["param_groups"] == r_opt["param_groups"]
    for i, st in s_opt["state"].items():
        assert all(torch.equal(st[k], r_opt["state"][i][k]) for k in st), i
    assert (straight.scheduler.plateau.state_dict() == resumed.scheduler.plateau.state_dict())
    assert straight.scheduler.plateau.num_bad == 0 or straight.scheduler.plateau.lr != 1e-3
    assert optim.current_learning_rate(s_state.optimizer) == optim.current_learning_rate(
        r_state.optimizer)
    b = load_checkpoint(tmp_path / "b" / "last.ckpt")
    assert b["epoch"] == 1 and b["scheduler"] == straight.scheduler.plateau.state_dict()


# ------------------------------------------------- schedules and optimizers

def test_schedules_match_jax():
    for e in range(12):
        assert schedules.warmup_cosine(e, lr=0.1, warmup_epochs=3, t_total=10, cycles=0.5) == \
            jsched.warmup_cosine(e, lr=0.1, warmup_epochs=3, t_total=10, cycles=0.5)
        assert schedules.cosine_annealing(e, lr=0.1, t_max=7) == \
            jsched.cosine_annealing(e, lr=0.1, t_max=7)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9]
    for name in ("warmup_cosine", "cosine", "reduce_on_plateau", "none"):
        kw = dict(scheduler=name, lr=0.01, warmup_epochs=2, max_epochs=9, t_max=5,
                  patience_scheduler=1)
        port, jax_s = schedules.scheduler_from_config(Config(**kw)), \
            jsched.scheduler_from_config(JConfig(**kw))
        for e, m in enumerate(metrics):
            assert port(e) == jax_s(e) and port(e, m) == jax_s(e, m), (name, e)
        if name == "reduce_on_plateau":
            assert port.plateau.state_dict() == jax_s.plateau.state_dict()
            assert port.plateau.lr < 0.01
    with pytest.raises(ValueError, match="scheduler"):
        schedules.scheduler_from_config(Config(scheduler="bogus"))


def _tree(rng):
    return {"swinViT": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "encoder10": {"w": rng.standard_normal(5).astype(np.float32)},
            "decoder1": {"w": rng.standard_normal((2, 3)).astype(np.float32)},
            "out": {"b": rng.standard_normal(4).astype(np.float32)}}


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


def _run_optax(tx, tree, grads, lrs=None):
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    for i, g in enumerate(grads):
        if lrs is not None:
            state = joptim.set_learning_rate(state, lrs[i])
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return _flat(jax.tree.map(np.asarray, params)), state


def _run_port(cfg, tree, grads, lrs=None, prefixes=()):
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in
              _flat(tree).items()}
    opt = optim.optimizer_from_config(cfg, params, prefixes)
    # one process: the window's mean has no ranks to be averaged over
    acc = (optim.Accumulation(cfg.iters_to_accumulate, lambda means, params: None)
           if cfg.iters_to_accumulate > 1 else None)
    for i, g in enumerate(grads):
        if lrs is not None:
            optim.set_learning_rate(opt, lrs[i])
        for n, p in params.items():
            p.grad = torch.from_numpy(_flat(g)[n].copy())
        opt.step() if acc is None else acc.step(opt)
    return {n: p.detach().numpy() for n, p in params.items()}, opt, acc


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_learning_rate_injection_matches_optax(rng, name):
    kw = dict(optim_name=name, lr=1e-3, reg_weight=1e-2, momentum=0.9)
    tree = _tree(rng)
    grads = [_tree(rng) for _ in range(4)]
    lrs = [1e-3, 5e-4, 5e-4, 1e-4]
    want, jstate = _run_optax(joptim.optimizer_from_config(JConfig(**kw)), tree, grads, lrs)
    got, opt, _ = _run_port(Config(**kw), tree, grads, lrs)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL_OPT, atol=ATOL_OPT, err_msg=n)
    assert optim.current_learning_rate(opt) == pytest.approx(
        joptim.current_learning_rate(jstate), rel=1e-7)


def test_freeze_encoder_matches_optax(rng):
    """Parameters under the encoder prefixes get no update and no decay,
    the rest JAX's; the mask names the same leaves as JAX's on the model."""
    kw = dict(optim_name="adamw", lr=1e-3, reg_weight=1e-1, freeze_encoder=True)
    prefixes = ("swinViT", "encoder1")           # 'encoder1' also matches encoder10
    tree = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    want, _ = _run_optax(joptim.optimizer_from_config(JConfig(**kw), tree, prefixes), tree,
                         grads)
    got, opt, _ = _run_port(Config(**kw), tree, grads, prefixes=prefixes)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL_OPT, atol=ATOL_OPT, err_msg=n)
    for n in ("swinViT.w", "encoder10.w"):
        np.testing.assert_array_equal(got[n], _flat(tree)[n])
    assert sum(len(g["params"]) for g in opt.param_groups) == 2

    model = engine.Trainer(Config(**CFG), device="cpu").model
    names = dict(model.named_parameters())
    frozen = optim.freeze_mask(names, model.ENCODER_PREFIXES)
    jparams = seeded_params(jax_model_from_config(JConfig(**CFG)), jnp.zeros((1, 32, 32, 32, 1)),
                            jnp.zeros((1,), jnp.int32))
    labels = joptim.freeze_mask(jparams, model.ENCODER_PREFIXES)
    jfrozen = {n for n, lab in state_dict_from_jax(jax.tree.map(
        lambda s, p: np.full(p.shape, s == "freeze"), labels, jparams)).items() if bool(lab.all())}
    assert frozen == jfrozen and 0 < len(frozen) < len(names)


def test_accumulation_and_tail_flush_match_optax(rng):
    """k = 3 over 7 micro-batches (Adam): `optax.MultiSteps`, then the
    epoch-end flush of the 1-batch tail (`make_accumulation_flush`)."""
    k, n = 3, 7
    kw = dict(optim_name="adam", lr=1e-3, reg_weight=0.0, iters_to_accumulate=k)
    tree = _tree(rng)
    grads = [_tree(rng) for _ in range(n)]
    tx = joptim.optimizer_from_config(JConfig(**kw))
    want, jstate = _run_optax(tx, tree, grads)
    got, opt, acc = _run_port(Config(**kw), tree, grads)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL_OPT, atol=ATOL_OPT, err_msg=name)
    assert (acc.mini_step, acc.gradient_step) == (int(jstate.mini_step),
                                                  int(jstate.gradient_step)) == (1, 2)
    jparams, jstate = joptim.make_accumulation_flush(tx, k)(
        jax.tree.map(jnp.asarray, {a: {b: want[f"{a}.{b}"] for b in s}
                                   for a, s in tree.items()}), jstate)
    assert acc.flush(opt) and not acc.flush(opt)
    got = {name: p.detach().numpy() for g in opt.param_groups for name, p in
           zip(_flat(tree), g["params"])}
    for name, v in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(got[name], v, rtol=RTOL_OPT, atol=ATOL_OPT, err_msg=name)
    assert acc.state_dict() == {"mini_step": 0, "gradient_step": 3}
    assert optim.optimizer_step_count(acc.state_dict(), k) == 9
    assert joptim.optimizer_step_count(jstate, k) == 9


def test_fit_flushes_the_accumulation_tail(small_dataset, params, tmp_path):
    """2 micro-batches an epoch with k = 3: the epoch ends with an applied
    step and an empty window, which the checkpoint records."""
    _, state, losses = _port_fit(small_dataset, params, tmp_path, iters_to_accumulate=3,
                                 max_epochs=1)
    assert len(losses) == state.step == 2
    assert (state.accumulation.mini_step, state.accumulation.gradient_step) == (0, 1)
    opt_state = load_checkpoint(tmp_path / "last.ckpt")["opt_state"]
    assert optim.optimizer_step_count(opt_state, 3) == 3   # one applied window of k


def test_early_stopping_matches_jax():
    values = [0.1, 0.2, 0.2005, 0.19, 0.3, 0.3, 0.29, 0.3, 0.31]
    for mode in ("max", "min"):
        port, jax_e = engine.EarlyStopping(3, 1e-3, mode), JEarlyStopping(3, 1e-3, mode)
        assert [port.update(v) for v in values] == [jax_e.update(v) for v in values]


# ----------------------------------------------------------------- dropout

def _flagship_small(**kw):
    return engine.Trainer(Config(**{**CFG, **kw}), device="cpu")


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((batch, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (batch, 32, 32, 32)),
            "modality": np.array([0, 1][:batch])}


def test_dropout_at_rate_zero_changes_nothing(monkeypatch):
    """The default rates: the train-mode forward is the eval-mode forward
    bit for bit, and window attention goes through K5's wrapper."""
    calls = []
    wrapped = port_swin.window_attention
    monkeypatch.setattr(port_swin, "window_attention",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    trainer = _flagship_small()
    x, mods = torch.from_numpy(_batch()["image"]), torch.tensor([0, 1], dtype=torch.int32)
    with torch.no_grad():
        train = trainer.model(x, mods)
        assert len(calls) == 8
        trainer.model.eval()
        assert torch.equal(train, trainer.model(x, mods))


def test_dropout_and_drop_path_statistics():
    p = 0.25
    x = torch.ones(200_000)
    drop, path = dropout.Dropout(p), dropout.DropPath(p)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    gen = torch.Generator().manual_seed(0)
    with dropout.rng(gen):
        y = drop(x)
        rows = path(torch.ones(4000, 3, 5))
    kept = y != 0
    assert torch.all(y[kept] == torch.tensor(1 / (1 - p)))
    n, frac = x.numel(), float(kept.float().mean())
    assert abs(frac - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5
    per_sample = rows.reshape(4000, -1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / (1 - p)).all(1))
    frac = float((per_sample[:, 0] != 0).float().mean())
    assert abs(frac - (1 - p)) < 4 * (p * (1 - p) / 4000) ** 0.5
    with dropout.rng(torch.Generator().manual_seed(0)):
        assert torch.equal(drop(x), y)
    drop.eval()
    path.eval()
    assert drop(x) is x and path(x) is x


def test_dropout_repeats_for_the_same_seed_and_step(monkeypatch):
    """The trainer's dropout stream is keyed (seed + 1, step): the same step
    gives the same loss, another step another; attention dropout in
    training runs the plain attention (the reference's route) and K5's
    wrapper is not called."""
    calls = []
    wrapped = port_swin.window_attention
    monkeypatch.setattr(port_swin, "window_attention",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    kw = dict(dropout_rate=0.2, attn_drop_rate=0.2, dropout_path_rate=0.3)
    losses = {}
    for name, step in (("a", 5), ("b", 5), ("c", 6)):
        trainer = _flagship_small(**kw)
        state = trainer.init_state()
        state.step = step
        losses[name] = float(trainer.value_and_grad(state, _batch(batch=1))[0])
    assert calls == []
    assert losses["a"] == losses["b"] != losses["c"]
    assert engine.step_seed(0, 5) == engine.step_seed(0, 5) != engine.step_seed(1, 5)


def test_fused_plan_rejects_dropout_in_training():
    block = UnetResBlock(4, 8, 3, 1, "instance", dropout=0.2, device="cpu")
    x = torch.zeros(1, 8, 8, 8, 4)
    assert _fuse_plan(block, x, None) is None
    block.eval()
    assert _fuse_plan(block, x, None) is not None
    plain = UnetResBlock(4, 8, 3, 1, "instance", device="cpu")
    assert _fuse_plan(plain, x, None) is not None


# ------------------------------------------------------------- evaluation

def test_eval_runs_eval_mode_on_one_cast(small_dataset, monkeypatch, tmp_path):
    """A model with dropout gives identical logits on two inferer calls, in
    eval mode (the eval forward), and stays in train mode after; one
    `evaluate` casts the masters once for all its windows and runs no
    autograd Function."""
    casts, applies = [], []
    window = engine.Trainer._eval_window
    monkeypatch.setattr(engine.Trainer, "_eval_window",
                        lambda self, w, m: casts.append(id(self._eval_cast)) or window(self, w, m))
    cfg = _config(Config, small_dataset, dropout_rate=0.3, attn_drop_rate=0.3,
                  dropout_path_rate=0.3, no_amp=False, precision="bf16")
    trainer = engine.Trainer(cfg, device="cpu", workdir=str(tmp_path),
                             logger=MetricLogger(tmp_path, quiet=True))
    state = trainer.init_state()
    x = torch.from_numpy(np.random.default_rng(1).random((1, 40, 32, 32, 1), np.float32))
    mods = torch.tensor([1], dtype=torch.int32)
    inferer = trainer.make_inferer()
    first, second = inferer(x, mods), inferer(x, mods)
    assert torch.equal(first, second) and trainer.model.training
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.apply_fn(state.params, x[:, :32], mods)
    trainer.model.train()
    casts.clear()
    apply = torch.autograd.Function.__dict__["apply"].__func__
    monkeypatch.setattr(torch.autograd.Function, "apply",
                        classmethod(lambda cls, *a, **k: applies.append(cls) or apply(cls, *a,
                                                                                       **k)))
    metrics = trainer.evaluate(MultiModalData(cfg).val_dataloader(), state)
    assert len(casts) == 2 and len(set(casts)) == 1 and not applies
    assert np.isfinite(metrics["val/loss/avg"]) and trainer.model.training
    assert trainer.history["eval_windows"] == [1, 1]
    assert torch.equal(trainer.make_inferer()(x[:, :32], mods), want)
    with dropout.rng(torch.Generator()):              # grad mode: the Functions run
        trainer.apply_fn(state.params, x[:, :32], mods)
    assert applies


# -------------------------------------------------------------------- CLI

def test_cli_train_and_test_run_from_a_command_line(small_dataset, tmp_path, monkeypatch,
                                                    capsys):
    argv = ["--model_name", "swin_unetr", "--out_channels", "4", "--feature_size", "12",
            "--num_heads", "2", "--roi_x", "32", "--roi_y", "32", "--roi_z", "32",
            "--encoder_norm_name", "instance_cond", "--vit_norm_name", "instance_cond",
            "--no_amp", "--precision", "fp32", "--max_epochs", "1", "--num_workers", "2",
            "--cache_num", "2", "--scheduler", "warmup_cosine", "--warmup_epochs", "1",
            "--data_dirs", str(small_dataset), str(small_dataset),
            "--json_lists", "CT.json", "MR.json", "--default_root_dir", str(tmp_path),
            "--experiment_name", "run", "--device", "cpu"]
    assert parse_args(argv)[1] == "cpu"
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    trainer, state, metrics = cli_train.main()
    assert trainer.device.type == "cpu" and state.step == 2
    assert "test_total_surface_distance/avg" in metrics
    assert "test_modality1_surface_distance/avg" in metrics
    assert all(np.isfinite(metrics[k]) for k in metrics if "dice" in k and "avg" in k)
    run = tmp_path / "run"
    assert (run / "best.ckpt").exists() and (run / "metrics.jsonl").exists()
    monkeypatch.setattr(sys, "argv", ["test", *argv, "--ckpt_path", str(run / "best.ckpt")])
    again = cli_test.main()
    assert again == metrics
    assert "test/accuracy/avg:" in capsys.readouterr().out
    # --auto_scale_batch_size runs the tuner, whose trials here fit at
    # batch 1 and run out of memory at 2
    def trial(cfg, batch_size, device=None):
        if batch_size > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(tuner, "_try_batch", trial)
    tuned, _, _ = cli_train.main(parse_args([*argv, "--auto_scale_batch_size"])[0],
                                 device="cpu")
    assert tuned.cfg.batch_size == 1
    assert "auto_scale_batch_size: training at batch_size=1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ckpt_path"):
        cli_test.main(parse_args(argv)[0], device="cpu")


def test_logging_and_profiling(tmp_path, capsys):
    """MetricLogger writes one JSON line a call (and a console line), with
    no wandb unless asked; profile_trace writes a Chrome trace of its
    region and does nothing without a directory; StepTimer leaves out its
    warm-up steps."""
    from miseg_tpu_torch.utils.profiling import StepTimer, profile_trace

    logger = MetricLogger(tmp_path / "log")
    logger.log({"a": 1, "b": 2.5}, step=3)
    logger.log({"c": np.float32(0.25)})
    logger.finish()
    lines = [json.loads(s) for s in open(tmp_path / "log" / "metrics.jsonl")]
    assert [sorted(ln) for ln in lines] == [["a", "b", "step", "ts"], ["c", "ts"]]
    assert lines[0]["b"] == 2.5 and lines[1]["c"] == 0.25
    assert "[step 3] a=1 b=2.5" in capsys.readouterr().err
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8).add_(1)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    timer = StepTimer(skip_first=1)
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(2))
    assert timer._count == 3 and timer.steps_per_sec > 0
