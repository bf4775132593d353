"""Entry points: `train` (a training run and its test), `test` (a
checkpoint's test metrics), `export` (checkpoint -> bundle), `predict_whs`
(native-space NIfTI export), `serve` (the HTTP server), `find_best_lr`
(the learning-rate range test), `tune` (the hyper-parameter search: TPE
and successive halving over training runs, into a JSONL journal),
`dashboard` (a study's report and web page from its journal) and
`sync_wandb` (uploads offline wandb runs).  Each that computes runs on
the CUDA card unless the caller names another device (`--device`, or
`--no_gpu` for the CPU)."""

from __future__ import annotations

from ..config import Config, build_parser
from ..utils.platform import requested_device


def parse_args(argv: list[str] | None = None) -> tuple[Config, str | None]:
    """`Config` from the command line (one flag per field), and the device
    asked for: `--device`, or the CPU under `--no_gpu` (which raises beside
    a `--device` that is not the CPU); None means the CUDA card."""
    parser = build_parser()
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    cfg = Config.from_args(args)
    return cfg, requested_device(args.device, cfg.no_gpu)
