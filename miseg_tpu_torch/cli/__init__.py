"""Entry points: `train` (a training run and its test), `test` (a
checkpoint's test metrics), `export` (checkpoint -> bundle), `predict_whs`
(native-space NIfTI export), `serve` (the HTTP server) and `find_best_lr`
(the learning-rate range test).  Each runs on the CUDA card unless the
caller names another device."""

from __future__ import annotations

from ..config import Config, build_parser


def parse_args(argv: list[str] | None = None) -> tuple[Config, str | None]:
    """`Config` from the command line (one flag per field), and `--device`
    (default: the CUDA card)."""
    parser = build_parser()
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    return Config.from_args(args), args.device
