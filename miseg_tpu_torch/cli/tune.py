"""`tune` — hyper-parameter search over training runs (counterpart of
`miseg_tpu/cli/tune.py`; the reference's tune.py:41-353).

    python -m miseg_tpu_torch.cli.tune --model_name swin_unetr \
        --out_channels 6 --encoder_norm_name instance_cond \
        --vit_norm_name instance_cond --scheduler warmup_cosine \
        --data_dirs dataset/MM-WHS dataset/MM-WHS \
        --json_lists CT_fold1.json MR.json --max_epochs 100 \
        --check_val_every_n_epoch 5 --n_trials 40 --study_name swin

A study (`hpo.create_study`): TPE seeded with `--seed`, successive
halving with `min_resource = 4 * check_val_every_n_epoch` and reduction
factor 3, its journal `<default_root_dir>/<storage_name>.journal.jsonl`,
resumed when it exists (whichever package began it), for `--n_trials`
trials or until `--timeout` seconds have passed (neither: until
stopped).  Each trial draws its hyper-parameters (`set_trial_config`),
writes them to `<default_root_dir>/<study_name>/<trial>/params.json`,
trains there (`Trainer.fit` on the CUDA card unless `--device` or
`--no_gpu` says otherwise, metrics to that directory's `metrics.jsonl`
and, with `--project`, to the wandb run `<study_name>_<trial>`),
reports every validation's accuracy to the pruner, and returns its best
accuracy.  A trial's trainer, state, loaders and logger are dropped
before the next trial begins, so its device memory is freed.  The best
trial is printed at the end; `cli.dashboard` reads the journal.

Data parallel over N cards (`torchrun --nproc_per_node=N -m
miseg_tpu_torch.cli.tune ...`), as the JAX package's multi-host search
(`miseg_tpu/cli/tune.py:30-87`): rank 0 alone holds the study, writes
its journal and each trial's `params.json` and metrics; every trial
trains on all ranks over the rank's shard of the train set, through a
`MultiHostTrial` whose suggestions and pruning decisions rank 0 makes and
broadcasts.  The other ranks follow rank 0's trials until it says the
study is over.  Every trial takes the mesh's modes, spatial partitioning
among them (`--spatial_shard --mesh_shape N --mesh_axes sp`, with JAX's
`--spatial_axis` default; `--fsdp --fsdp_axis sp` beside it), and its
validations fan their window groups out over the mesh's first axis.
"""

from __future__ import annotations

import gc
import json
import os
from pathlib import Path

import numpy as np

from .. import parallel
from ..config import Config
from ..data.multi_modal import MultiModalData
from ..hpo import SuccessiveHalvingPruner, TPESampler, TrialPruned, create_study
from ..train.engine import Trainer
from ..utils.logging import MetricLogger
from . import parse_args


class MultiHostTrial:
    """A trial on every rank whose values come from rank 0 (the JAX
    package's `MultiHostTrial`, `miseg_tpu/cli/tune.py:30-87`; the
    reference's `TorchDistributedTrial`): rank 0 asks its study trial and
    broadcasts each suggestion (a categorical as its index) and each
    pruning decision; reports reach the study from rank 0 alone.  Every
    suggested number comes back through float32 on every rank, rank 0's
    too, as JAX's `_bcast` sends it through a default-precision
    `jnp.asarray`."""

    def __init__(self, trial):
        self._trial = trial
        self.number = parallel.broadcast_object(trial.number if trial is not None else None)
        self.params: dict = {}

    def _bcast(self, value) -> float:
        return parallel.broadcast_object(float(np.float32(value if value is not None else 0.0)))

    def _suggest(self, fn_name, name, *args, **kw):
        v = getattr(self._trial, fn_name)(name, *args, **kw) if parallel.is_writer() else None
        out = self._bcast(v)
        self.params[name] = out
        return out

    def suggest_float(self, name, low, high, *, log=False):
        return self._suggest("suggest_float", name, low, high, log=log)

    def suggest_int(self, name, low, high):
        return int(self._suggest("suggest_int", name, low, high))

    def suggest_categorical(self, name, choices):
        idx = (list(choices).index(self._trial.suggest_categorical(name, list(choices)))
               if parallel.is_writer() else 0)
        out = choices[int(self._bcast(idx))]
        self.params[name] = out
        return out

    def report(self, value, step):
        if parallel.is_writer():
            self._trial.report(value, step)

    def should_prune(self) -> bool:
        decision = self._trial.should_prune() if parallel.is_writer() else False
        return bool(self._bcast(1.0 if decision else 0.0))


def set_trial_config(trial, cfg: Config) -> Config:
    """Per-model search space (tune.py:41-77): the lr, the weight decay, the
    scheduler's own parameter and, unless the encoder is frozen or the
    weights pretrained, the model's widths."""
    over: dict = {
        "lr": trial.suggest_float("lr", cfg.min_lr, cfg.max_lr, log=True),
        "reg_weight": trial.suggest_float("reg_weight", 1e-6, 1e-4),
    }
    if cfg.scheduler == "warmup_cosine":
        over["warmup_epochs"] = trial.suggest_int(
            "warmup_epochs", 0, 3 * cfg.check_val_every_n_epoch)
    elif cfg.scheduler == "cosine":
        over["t_max"] = trial.suggest_int("t_max", 400, cfg.max_epochs)
    elif cfg.scheduler == "reduce_on_plateau":
        over["patience_scheduler"] = trial.suggest_int("patience_scheduler", 2, 10)
    if not cfg.freeze_encoder and not cfg.pretrained:
        if cfg.model_name == "unet":
            over["feature_size"] = [trial.suggest_categorical("feature_size", [8, 16, 32])]
            n = trial.suggest_int("num_layers", 3, 5)
            over["num_layers"] = n
            over["strides"] = [2] * (n - 1)
        elif cfg.model_name == "unetr":
            over["feature_size"] = [trial.suggest_categorical("feature_size", [8, 16, 32])]
            over["num_heads"] = trial.suggest_categorical("num_heads", [8, 12, 16])
        elif cfg.model_name in ("swin_unetr", "pre_swin_unetr"):
            over["feature_size"] = [trial.suggest_categorical("feature_size", [12, 24, 36])]
            over["num_heads"] = trial.suggest_categorical("num_heads", [2, 3, 4])
    return cfg.replace(**over)


def _fit_trial(cfg: Config, trial, logdir: str, device) -> tuple[float, bool]:
    """Train `cfg` in `logdir`, reporting each validation's accuracy to
    `trial`; returns (the best accuracy, whether the pruner stopped it).
    Everything it builds dies with its frame."""
    parallel.mesh_from_config(cfg)
    shard, num_shards = parallel.host_shard_info()
    data = MultiModalData(cfg, shard=shard, num_shards=num_shards)
    if parallel.is_writer():
        logger = MetricLogger(logdir, wandb_kwargs=(
            {"project": cfg.project, "entity": cfg.entity, "group": cfg.study_name,
             "id": f"{cfg.study_name}_{trial.number}", "mode": cfg.wandb_mode,
             "dir": logdir} if cfg.project else None))
    else:
        logger = MetricLogger(None, quiet=True)
    trainer = Trainer(cfg, device=device, workdir=logdir, logger=logger)
    best = {"acc": -1.0, "pruned": False}

    def report(epoch: int, acc: float) -> bool:
        best["acc"] = max(best["acc"], acc)
        trial.report(acc, epoch)
        if trial.should_prune():
            best["pruned"] = True
            return True
        return False

    try:
        trainer.fit(data, report_callback=report)
    finally:
        logger.finish()
    return best["acc"], best["pruned"]


def objective(base_cfg: Config, trial, device=None) -> float:
    """One trial (`miseg_tpu/cli/tune.py:120`): its config, `params.json`,
    a training run on `device`; raises `TrialPruned` when the pruner
    stopped it, else returns its best validation accuracy.  Under data
    parallelism every rank runs it, the trial a `MultiHostTrial` (None
    outside rank 0)."""
    if parallel.group() is not None and not isinstance(trial, MultiHostTrial):
        trial = MultiHostTrial(trial)
    cfg = set_trial_config(trial, base_cfg)
    logdir = os.path.join(cfg.default_root_dir, cfg.study_name, str(trial.number))
    if parallel.is_writer():
        Path(logdir).mkdir(parents=True, exist_ok=True)
        with open(os.path.join(logdir, "params.json"), "w") as f:
            json.dump(trial.params, f)
    acc, pruned = _fit_trial(cfg, trial, logdir, device)
    gc.collect()   # the trainer's inferers refer back to it: free the cycle now
    if pruned:
        raise TrialPruned()
    return acc


def main(cfg: Config | None = None, *, device=None):
    """Run (or resume) `cfg`'s study on `device` (the CUDA card unless
    given); returns the study (None on the ranks other than 0)."""
    if cfg is None:
        cfg, device = parse_args()
    device = parallel.init_process_group(device, no_gpu=cfg.no_gpu)
    if not parallel.is_writer():
        _follow(cfg, device)
        return None
    storage = os.path.join(cfg.default_root_dir, f"{cfg.storage_name}.journal.jsonl")
    study = create_study(
        study_name=cfg.study_name, storage=storage,
        sampler=TPESampler(seed=cfg.seed),
        pruner=SuccessiveHalvingPruner(
            min_resource=4 * cfg.check_val_every_n_epoch, reduction_factor=3),
        direction="maximize", load_if_exists=True)
    study.optimize(lambda t: objective(cfg, t, device), n_trials=cfg.n_trials,
                   timeout=cfg.timeout)
    parallel.broadcast_object(None)   # no further trial: the followers stop
    best = study.best_trial
    if best is not None:
        print(f"best trial #{best.number}: value={best.value:.4f} params={best.params}")
    return study


def _follow(cfg: Config, device) -> None:
    """A rank other than 0: run each trial rank 0 starts (its number comes
    first, `MultiHostTrial`), until rank 0 broadcasts None."""
    while (trial := MultiHostTrial(None)).number is not None:
        try:
            objective(cfg, trial, device)
        except TrialPruned:
            pass


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.destroy_process_group()
