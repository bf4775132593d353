"""One rank of the data-parallel CPU tests (`tests/test_torch_ddp.py`).

    python tests/_torch_ddp_worker.py RANK WORLD RDZV_FILE OUT_DIR DATA_DIR STARTS

Joins a gloo process group through a `file://` rendezvous (no port, so
concurrent test workers never collide), then runs, on its shard of each
global batch (`batch_for_rank`):
  * two AdamW train steps of each `STEP_CASES` model, and two micro-steps
    of `ACCUM_CASE` under `iters_to_accumulate` = 2 (gradient buckets of
    64 KiB, so the all-reduce spans several), each from the state dict
    of its case in the file `STARTS` (`torch.save`d `{case: state dict}`;
    a case it lacks starts from the port's seeded initialisation);
  * the Trainer's mesh (`parallel.mesh_from_config`)
    at world 2, and a step of the pipeline mode without a pipeline line;
  * `cli.tune.main` of 3 trials with the training stubbed out (rank 0
    holds the study; every rank records what each trial received);
  * one epoch of `cli.train.main` on `DATA_DIR`, counting each rank's
    checkpoint writes;
and saves what it saw to `OUT_DIR/rank<RANK>.pt`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from miseg_tpu_torch import parallel  # noqa: E402
from miseg_tpu_torch.config import Config  # noqa: E402
from miseg_tpu_torch.parallel import mesh  # noqa: E402
from miseg_tpu_torch.train import engine  # noqa: E402

_STEP = dict(criterion="dice_focal", optim_name="adamw", lr=1e-4, reg_weight=1e-5,
             no_amp=True, out_channels=4, encoder_norm_name="instance_cond",
             vit_norm_name="instance_cond", decoder_norm_name="instance")
STEP_CASES = {
    # the flagship's model at fs 12 with dropout and drop-path in training
    "swin_unetr": dict(_STEP, model_name="swin_unetr", feature_size=[12], num_heads=2,
                       roi_x=32, roi_y=32, roi_z=32, dropout_rate=0.1,
                       dropout_path_rate=0.2),
    "unet_vanilla_batch": dict(_STEP, model_name="unet_vanilla",
                               feature_size=[4, 8, 8, 16, 16], strides=[1, 2, 2, 2, 1],
                               num_res_units=2, encoder_norm_name="batch",
                               decoder_norm_name="batch", roi_x=16, roi_y=16, roi_z=16),
}
ACCUM_CASE = dict(STEP_CASES["unet_vanilla_batch"], iters_to_accumulate=2)
# a C-UNet (a model spatial partitioning takes) with FSDP on the spatial line
SP_UNET = dict(model_name="unet", feature_size=[8], num_layers=2, strides=[2],
               num_res_units=1, spatial_shard=True, fsdp=True, fsdp_axis="sp")
GLOBAL_BATCH = 2
STEPS = 2


def global_batches(cfg: dict, steps: int = STEPS, seed: int = 0) -> list[dict]:
    """`steps` global batches of `GLOBAL_BATCH` for a case, from a seed."""
    rng = np.random.default_rng(seed)
    roi = (cfg["roi_x"], cfg["roi_y"], cfg["roi_z"])
    return [{"image": rng.standard_normal((GLOBAL_BATCH, *roi, 1)).astype(np.float32),
             "label": rng.integers(0, cfg["out_channels"],
                                   (GLOBAL_BATCH, *roi, 1)).astype(np.int32),
             "modality": np.array([0, 1], np.int32)} for _ in range(steps)]


def batch_for_rank(batch: dict, rank: int, world: int) -> dict:
    n = GLOBAL_BATCH // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def run_steps(cfg: dict, rank: int, world: int, start: dict | None = None) -> dict:
    """The parameters, buffers and losses after `STEPS` micro-steps on
    this rank's shards (the whole batch at world 1) from the state dict
    `start` (None: the port's own initialisation), the parameters and
    buffers after the first, and the gradients the last update applied (averaged over the
    ranks)."""
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.init_state(start)
    losses, first, params1 = [], None, None
    for batch in global_batches(cfg):
        state, loss = trainer.train_step(state, batch_for_rank(batch, rank, world))
        losses.append(float(loss))
        first = first or {n: b.clone() for n, b in state.buffers.items()}
        params1 = params1 or {n: p.detach().clone() for n, p in state.params.items()}
    return {"params": {n: p.detach().clone() for n, p in state.params.items()},
            "params_step1": params1,
            "buffers": {n: b.clone() for n, b in state.buffers.items()},
            "buffers_step1": first,
            "grads": {n: p.grad.clone() for n, p in state.params.items()},
            "losses": losses, "optimizer_steps": optimizer_steps(state)}


def optimizer_steps(state) -> int:
    steps = [int(s["step"]) for s in state.optimizer.state.values() if "step" in s]
    return max(steps) if steps else 0


def mesh_checks() -> dict:
    """What the Trainer says of each mesh and mode at world 2: None when it
    builds, else the error's type and message; and the losses of one step
    of the pipeline mode on the 1-D "data" mesh (no pipeline line of more
    than one rank: the data-parallel step) and of data parallelism, on
    this rank's shard of one batch."""
    cfg = STEP_CASES["unet_vanilla_batch"]
    rank, world = dist.get_rank(), dist.get_world_size()
    batch = batch_for_rank(global_batches(cfg, 1)[0], rank, world)
    steps = {}
    for name, kw in (("pipeline_parallel", {"pipeline_parallel": True}), ("data", {})):
        trainer = engine.Trainer(Config(**dict(cfg, **kw)), device="cpu")
        steps[name] = float(trainer.train_step(trainer.init_state(), batch)[1])
    out = {"pp_off_step": steps}
    for name, kw in {"mesh_-1": {"mesh_shape": [-1]}, "mesh_2": {"mesh_shape": [2]},
                     "mesh_4": {"mesh_shape": [4]}, "mesh_1": {"mesh_shape": [1]},
                     "axes_model": {"mesh_axes": ["data", "model"]},
                     "fsdp": {"fsdp": True}, "spatial_shard": {"spatial_shard": True},
                     "spatial_fsdp": {**SP_UNET, "mesh_axes": ["sp"]},
                     "spatial_fsdp_tp": {**SP_UNET, "mesh_shape": [2, 1],
                                         "mesh_axes": ["sp", "model"], "tensor_parallel": True},
                     "tensor_parallel": {"tensor_parallel": True},
                     "pipeline_parallel": {"pipeline_parallel": True}}.items():
        cfg = Config(**dict(STEP_CASES["unet_vanilla_batch"], **kw))
        try:
            engine.Trainer(cfg, device="cpu")
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def tune_study(root: str, rank: int) -> dict:
    """`cli.tune.main` over the ranks with `_fit_trial` stubbed: what each
    trial's config and `MultiHostTrial` held on this rank."""
    from miseg_tpu_torch.cli import tune
    seen = []

    def fit(cfg, trial, logdir, device):
        seen.append({"number": trial.number, "params": dict(trial.params),
                     "lr": cfg.lr, "feature_size": cfg.feature_size,
                     "num_heads": cfg.num_heads, "warmup_epochs": cfg.warmup_epochs})
        # every rank reports; rank 0's pruner decides for all
        trial.report(0.1 * (trial.number + 1), 0)
        return 0.1 * (trial.number + 1), trial.should_prune()

    tune._fit_trial = fit
    cfg = Config(model_name="swin_unetr", scheduler="warmup_cosine",
                 default_root_dir=root, study_name="ddp", storage_name="ddp",
                 n_trials=3, check_val_every_n_epoch=1, seed=3)
    study = tune.main(cfg, device="cpu")
    return {"seen": seen, "is_study": study is not None,
            "trials": None if study is None else [
                {"number": t.number, "params": dict(t.params), "state": t.state}
                for t in study.trials]}


def train_fit(root: str, data_dir: str) -> dict:
    """One epoch of `cli.train.main`; this rank's checkpoint writes."""
    from miseg_tpu_torch.cli import train as cli_train
    from miseg_tpu_torch.train import checkpoint
    writes = []
    real = checkpoint.save_checkpoint

    def counting(path, **kw):
        writes.append(str(path))
        return real(path, **kw)

    checkpoint.save_checkpoint = counting
    engine.save_checkpoint = counting
    cfg = Config(**dict(STEP_CASES["unet_vanilla_batch"], default_root_dir=root,
                        experiment_name="fit", data_dirs=[data_dir] * 2,
                        json_lists=["CT.json", "MR.json"], max_epochs=1,
                        check_val_every_n_epoch=1, batch_size=1, num_workers=0,
                        cache_num=8, patches_training_sample=1))
    trainer, state, metrics = cli_train.main(cfg, device="cpu")
    return {"writes": writes, "steps": state.step,
            "test_dice": metrics["test/accuracy/avg"],
            "params": {n: p.detach().clone() for n, p in state.params.items()}}


def main(rank: int, world: int, rdzv: str, out_dir: str, data_dir: str,
         starts: str) -> None:
    torch.set_num_threads(1)
    start = torch.load(starts, weights_only=True)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    try:
        assert parallel.host_shard_info() == (rank, world)
        mesh.BUCKET_BYTES = 64 << 10
        result = {name: run_steps(cfg, rank, world, start.get(name))
                  for name, cfg in STEP_CASES.items()}
        result["accumulate"] = run_steps(ACCUM_CASE, rank, world, start.get("accumulate"))
        result["mesh"] = mesh_checks()
        result["tune"] = tune_study(str(Path(out_dir) / "tune"), rank)
        result["fit"] = train_fit(str(Path(out_dir) / "fit"), data_dir)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
         sys.argv[6])
