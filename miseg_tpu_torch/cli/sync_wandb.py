"""`sync_wandb` — upload offline wandb runs (counterpart of
`miseg_tpu/cli/sync_wandb.py`; the reference's `utils/sync_wandb.py:5-27`,
for clusters whose nodes have no network).

    python -m miseg_tpu_torch.cli.sync_wandb --dir experiments/swin/0/wandb

Runs `wandb sync <run>` for every `offline-run-*` directory under
`--dir`; where wandb does not import, lists them instead.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="./wandb", help="wandb offline runs dir")
    args = p.parse_args(argv)
    runs = sorted(Path(args.dir).glob("offline-run-*"))
    if not runs:
        print(f"no offline runs under {args.dir}")
        return
    try:
        import wandb  # noqa: F401
    except ImportError:
        print(f"wandb not installed; {len(runs)} offline runs pending sync:")
        for r in runs:
            print(f"  {r}")
        return
    for r in runs:
        subprocess.run(["wandb", "sync", str(r)], check=False)


if __name__ == "__main__":
    main()
