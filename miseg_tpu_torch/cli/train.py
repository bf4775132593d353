"""`train` — a training run, then a test of its best checkpoint
(counterpart of `miseg_tpu/cli/train.py`).

    python -m miseg_tpu_torch.cli.train --model_name swin_unetr \
        --feature_size 48 --num_heads 3 --out_channels 6 \
        --encoder_norm_name instance_cond --vit_norm_name instance_cond \
        --data_dirs dataset/MM-WHS dataset/MM-WHS \
        --json_lists CT_fold1.json MR.json --max_epochs 100

Parse the command line; with `--auto_scale_batch_size`, find the
largest batch size whose step fits in memory (`train/tuner.py`, inside
the reference's `try`: a failed search keeps the batch size); build the
CT + MR data module, the metric logger
(`<default_root_dir>/<experiment_name or study_name>/metrics.jsonl`, and
wandb when `--project` is given and wandb imports), the `Trainer` and its
fresh state (`pre_swin_unetr`'s `--pre_swin` and the `--pretrained`
ingest), `fit` (resuming from `--ckpt_path` when given), then evaluate
`best.ckpt` on the test split with Dice and symmetric surface distance.

Data parallel over N cards, one process each (`parallel`): the same
command under `torchrun --nproc_per_node=N -m miseg_tpu_torch.cli.train
...`.  `--batch_size` is per data coordinate, the train set is sharded by
the "data" coordinate, and rank 0 writes the checkpoints and metrics.
FSDP and tensor parallelism take JAX's flags over a mesh of the ranks:
`--fsdp` (on "data", or `--fsdp_axis model` of `--mesh_shape 2 2
--mesh_axes data model`), `--tensor_parallel --mesh_shape 2 2
--mesh_axes data model`, or both.  Spatial partitioning takes JAX's
`--spatial_shard` (and `--spatial_axis`, default "sp"): `torchrun
--nproc_per_node=4 -m miseg_tpu_torch.cli.train --spatial_shard
--mesh_shape 4 --mesh_axes sp ...` splits each training patch's D (H
under `--spatial_dims 2`) over four ranks, for every `--model_name`
(`parallel/spatial.py`; `--mesh_shape 2 2 --mesh_axes data sp` with data
parallelism; beside tensor or pipeline parallelism it raises), and
`--fsdp` beside it shards the masters and
moments over "data" or, with `--fsdp_axis sp`, over the spatial line.
Validation and the test run on every rank, their window groups fanned
out over the mesh's first axis (each rank predicts ⌈G/N⌉ of the G
groups; the logits are one process's).

Fine-tuning the flagship from MONAI's SSL Swin-ViT, with recompute:

    python -m miseg_tpu_torch.cli.train --model_name pre_swin_unetr \
        --pre_swin model_swinvit.pt --use_checkpoint --feature_size 48 ...
"""

from __future__ import annotations

import os

from .. import parallel
from ..config import Config
from ..data.multi_modal import MultiModalData
from ..train.checkpoint import load_checkpoint
from ..train.engine import Trainer, TrainState
from ..train.tuner import scale_batch_size
from ..utils.logging import MetricLogger
from . import parse_args


def main(cfg: Config | None = None, *, device=None) -> tuple[Trainer, TrainState, dict]:
    """Run `cfg`'s training on `device` (the CUDA card unless given);
    returns the trainer (its `history` holds the host timings), the final
    state and the test metrics."""
    if cfg is None:
        cfg, device = parse_args()
    device = parallel.init_process_group(device, no_gpu=cfg.no_gpu)
    if cfg.auto_scale_batch_size:
        # the reference's `try: trainer.tune(...)` (train.py:57-60)
        try:
            bs = scale_batch_size(cfg, device=device)
            print(f"auto_scale_batch_size: training at batch_size={bs}")
            cfg = cfg.replace(batch_size=bs)
        except Exception as e:  # noqa: BLE001 -- the reference trains on at its batch size
            print(f"Tuning of batch size not possible: {e}")
    workdir = os.path.join(cfg.default_root_dir, cfg.experiment_name or cfg.study_name)
    parallel.mesh_from_config(cfg)
    shard, num_shards = parallel.host_shard_info()
    data = MultiModalData(cfg, shard=shard, num_shards=num_shards)
    if parallel.is_writer():
        logger = MetricLogger(workdir, wandb_kwargs=(
            {"project": cfg.project, "entity": cfg.entity, "group": cfg.group,
             "name": cfg.experiment_name, "mode": cfg.wandb_mode, "dir": workdir}
            if cfg.project else None))
    else:
        logger = MetricLogger(None, quiet=True)
    trainer = Trainer(cfg, device=device, workdir=workdir, logger=logger)
    state = trainer.fit(data, state=trainer.fresh_state())

    best = os.path.join(workdir, "best.ckpt")
    if os.path.exists(best):
        trainer.restore(state, {"params": load_checkpoint(best)["params"]})
    metrics = trainer.evaluate(data.test_dataloader(), state, prefix="test",
                               compute_surface=True)
    print({k: round(v, 4) for k, v in metrics.items()})
    logger.finish()
    return trainer, state, metrics


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.destroy_process_group()
