"""`cli.tune` of the port against the JAX package's, on the CPU.

* `set_trial_config`: the same Config (every field) and the same trial
  params as JAX's for all five models under each scheduler, with
  `freeze_encoder` and `pretrained` on and off.
* `cli.tune.main` end to end, both packages on one synthetic CT + MR set
  (32^3 volumes, 1 train / 1 val volume a modality, one window each):
  `tests/test_torch_fit.py`'s C-Swin-UNETR (depth 2, 4 classes, f32)
  under SGD, 3 trials of 4 epochs, a validation every epoch (so the
  pruner's first rung falls at epoch index 3), then a resumed study of 1
  more trial on the same journal.  Each model starts from the same
  seeded parameters in both packages (JAX's flax init and the port's
  torch init are replaced by `seeded_params` of the trial's widths).
  Held: identical trial params and states; every reported accuracy and
  every trial's value within ATOL_ACC = 1e-3 of JAX's
  (`tests/test_torch_fit.py`'s fit-to-fit Dice bound under SGD); every
  comparison the pruner makes decided by a margin above 2 x ATOL_ACC,
  so that a decision that the tolerance could flip cannot pass unseen
  (trials drawn with the same params repeat their values exactly, in
  both packages, and are not compared); each `params.json` equal to the
  journal's `param` records; no trainer alive when a trial is told.
"""

import dataclasses
import functools
import gc
import json
import math
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import seeded_params
from test_torch_fit import CFG

from miseg_tpu import hpo as jhpo
from miseg_tpu.cli import tune as jtune
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train import engine as jengine
from miseg_tpu.train.engine import Trainer as JTrainer
from miseg_tpu_torch import hpo
from miseg_tpu_torch.cli import tune
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_ACC = 1e-3
TUNE = dict(CFG, optim_name="sgd", max_epochs=4, n_trials=3, study_name="swin",
            storage_name="MI-Seg")
MODELS = ["unet", "unet_vanilla", "unetr", "swin_unetr", "pre_swin_unetr"]
SCHEDULERS = ["warmup_cosine", "cosine", "reduce_on_plateau", "none"]


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("pretrained", [None, "weights.pt"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("model", MODELS)
def test_set_trial_config_equals_jax(model, scheduler, pretrained, frozen):
    base = dict(model_name=model, scheduler=scheduler, pretrained=pretrained,
                freeze_encoder=frozen, max_epochs=600, check_val_every_n_epoch=5)
    got, want = [], []
    for pkg, cls, mod, out in ((hpo, Config, tune, got), (jhpo, JConfig, jtune, want)):
        study = pkg.create_study(sampler=pkg.TPESampler(seed=2))
        for _ in range(3):
            trial = study.ask()
            out.append((dataclasses.asdict(mod.set_trial_config(trial, cls(**base))),
                        trial.params))
            study.tell(trial, 0.5)
    assert got == want
    widths = {"feature_size", "num_heads", "num_layers"}   # unet_vanilla's are not searched
    searched = not frozen and not pretrained and model != "unet_vanilla"
    assert bool(widths & set(got[0][1])) == searched


@functools.lru_cache(maxsize=None)
def _params(fs: int, heads: int):
    """Seeded JAX parameters of `TUNE`'s model at these widths."""
    model = jax_model_from_config(JConfig(**{**TUNE, "feature_size": [fs], "num_heads": heads}))
    return seeded_params(model, jnp.zeros((1, 32, 32, 32, 1)), jnp.zeros((1,), jnp.int32),
                         seed=3)


def _study_run(cls, main, root, data, **kw):
    cfg = cls(**{**TUNE, "data_dirs": [str(data)] * 2, "default_root_dir": str(root), **kw})
    return main(cfg) if cls is JConfig else main(cfg, device="cpu")


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """Both packages' 3-trial studies and their 1-trial resumes, each
    trial started from `_params`; with the port's trainers, weakly, and
    at each `tell` whether every earlier trial's trainer is gone."""
    data = tmp_path_factory.mktemp("tunedata")
    make_synthetic_dataset(data, shape=(32, 32, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=6)
    roots = {k: tmp_path_factory.mktemp(k) for k in ("jax", "port")}
    trainers, freed = [], []
    j_init, p_init = JTrainer.init_state, engine.Trainer.init_state
    p_fit, p_tell = engine.Trainer.fit, hpo.Study.tell

    def jax_init(self, image, modality, rng=None, *, params=None, extra_vars=None):
        params = params or _params(self.cfg.feature_size_scalar, self.cfg.num_heads)
        return j_init(self, image, modality, params=params, extra_vars=extra_vars)

    def port_init(self, params=None):
        return p_init(self, params or state_dict_from_jax(
            _params(self.cfg.feature_size_scalar, self.cfg.num_heads)))

    def port_fit(self, *args, **kwargs):
        trainers.append(weakref.ref(self))
        return p_fit(self, *args, **kwargs)

    def port_tell(self, *args, **kwargs):
        freed.append(all(r() is None for r in trainers))
        return p_tell(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "make_mesh", lambda shape, axes: jax.sharding.Mesh(
            np.array(jax.devices()[:1]), tuple(axes)))   # one device, as the port
        mp.setattr(JTrainer, "init_state", jax_init)
        mp.setattr(engine.Trainer, "init_state", port_init)
        mp.setattr(engine.Trainer, "fit", port_fit)
        mp.setattr(hpo.Study, "tell", port_tell)
        out = {}
        for name, cls, main in (("jax", JConfig, jtune.main), ("port", Config, tune.main)):
            first = _study_run(cls, main, roots[name], data)
            out[name] = dict(first=[(t.number, t.state) for t in first.trials],
                             resumed=_study_run(cls, main, roots[name], data, n_trials=1),
                             root=roots[name])
    gc.collect()
    out["freed"], out["trainers"] = freed, trainers
    return out


def _journal(root):
    return [json.loads(line) for line in open(Path(root) / "MI-Seg.journal.jsonl")]


def test_tune_matches_jax(studies):
    jax_study, port_study = studies["jax"]["resumed"], studies["port"]["resumed"]
    assert studies["port"]["first"] == studies["jax"]["first"]
    assert [t for t, _ in studies["port"]["first"]] == [0, 1, 2]
    rows = []
    for j, p in zip(jax_study.trials, port_study.trials, strict=True):
        assert (p.number, p.state, p.params) == (j.number, j.state, j.params)
        assert sorted(p.intermediate) == sorted(j.intermediate)
        gap = max(abs(p.intermediate[s] - j.intermediate[s]) for s in j.intermediate)
        rows.append((p.number, p.state, p.params["feature_size"], p.params["num_heads"],
                     j.value, p.value, gap))
        assert abs(p.value - j.value) <= ATOL_ACC and gap <= ATOL_ACC
    for row in rows:
        print("trial {} {}: fs {} heads {}, value JAX {:.6f} port {:.6f}, worst "
              "report |diff| {:.2e}".format(*row))
    assert len(rows) == 4 and {s for _, s, *_ in rows} <= {"complete", "pruned"}
    assert port_study.best_trial.number == jax_study.best_trial.number
    # the journals: the same records but their time stamps and values
    strip = [[{k: v for k, v in r.items() if k not in ("ts", "value")} for r in _journal(
        studies[k]["root"])] for k in ("jax", "port")]
    assert strip[1] == strip[0]


def _comparisons(study_records, min_resource: int, rf: int = 3):
    """Every comparison successive halving makes while the journal's
    reports arrive: (trial, step, its best value at the rung, the other
    trials' best values there, whether it is pruned)."""
    inter: dict[int, dict[int, float]] = {}
    out = []
    for r in study_records:
        if r["op"] != "report":
            continue
        inter.setdefault(r["trial"], {})[r["step"]] = r["value"]
        if r["step"] + 1 < min_resource:
            continue
        rung = int(math.floor(math.log((r["step"] + 1) / min_resource, rf) + 1e-9))
        resource = min_resource * rf ** rung
        best = {t: max(v for s, v in iv.items() if s + 1 <= resource)
                for t, iv in inter.items() if any(s + 1 <= resource for s in iv)}
        if len(best) < rf:
            continue
        cutoff = sorted(best.values(), reverse=True)[math.ceil(len(best) / rf) - 1]
        mine = best.pop(r["trial"])
        out.append((r["trial"], r["step"], mine, best, mine < cutoff))
    return out


def test_pruning_margins_exceed_the_tolerance(studies):
    """The pruner's decisions rebuilt from each journal equal the states
    the studies reached, and each rests on gaps wider than 2 x ATOL_ACC."""
    trials = {t.number: t for t in studies["jax"]["resumed"].trials}
    comps = {k: _comparisons(_journal(studies[k]["root"]), min_resource=4)
             for k in ("jax", "port")}
    assert [c[:2] + c[4:] for c in comps["port"]] == [c[:2] + c[4:] for c in comps["jax"]]
    assert comps["jax"], "the pruner compared nothing"
    margins = []
    for (trial, step, mine, others, pruned), (_, _, p_mine, p_others, _) in zip(
            comps["jax"], comps["port"]):
        assert pruned == (trials[trial].state == "pruned"
                          and step == max(trials[trial].intermediate))
        for other, value in others.items():
            if trials[other].params == trials[trial].params:
                # the same params train the same run: exactly equal in each package
                assert value == mine and p_others[other] == p_mine
                continue
            margins.append(abs(mine - value))
    print(f"pruning comparisons: {len(comps['jax'])}, smallest margin {min(margins):.3e} "
          f"(> 2 x {ATOL_ACC:g})")
    assert min(margins) > 2 * ATOL_ACC


def test_trials_leave_params_json_and_no_trainer(studies):
    root = Path(studies["port"]["root"])
    by_trial: dict[int, dict] = {}
    for r in _journal(root):
        if r["op"] == "param":
            by_trial.setdefault(r["trial"], {})[r["name"]] = r["value"]
    assert sorted(by_trial) == [0, 1, 2, 3]
    for number, params in by_trial.items():
        assert json.loads((root / "swin" / str(number) / "params.json").read_text()) == params
        assert (root / "swin" / str(number) / "metrics.jsonl").exists()
    assert studies["freed"] == [True] * 4 and len(studies["trainers"]) == 4
    assert all(r() is None for r in studies["trainers"])
