"""Metric logging (counterpart of `miseg_tpu/utils/logging.py`): one
`{"ts", "step", **metrics}` line a call in `<directory>/metrics.jsonl`,
a console line on stderr, and wandb only when the caller asks for it
(`wandb_kwargs`) and the package imports.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, directory: str | Path | None = None,
                 wandb_kwargs: dict | None = None, quiet: bool = False):
        self.quiet = quiet
        self._fh = None
        if directory is not None:
            d = Path(directory)
            d.mkdir(parents=True, exist_ok=True)
            self._fh = open(d / "metrics.jsonl", "a")
        self._wandb = None
        if wandb_kwargs is not None:
            try:
                import wandb
            except ImportError:
                print("MetricLogger: wandb is not installed; logging to metrics.jsonl "
                      "only", file=sys.stderr)
            else:
                self._wandb = wandb.init(**wandb_kwargs)

    def log(self, metrics: dict, step: int | None = None) -> None:
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) for k, v in metrics.items()}}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if not self.quiet:
            head = f"[step {step}] " if step is not None else ""
            body = " ".join(f"{k}={v:.5g}" for k, v in metrics.items()
                            if isinstance(v, (int, float)))
            print(head + body, file=sys.stderr)

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
