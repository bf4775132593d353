"""`find_best_lr` — the learning-rate range test (counterpart of
`miseg_tpu/cli/find_best_lr.py`; the reference's `trainer.tuner.lr_find`).

    python -m miseg_tpu_torch.cli.find_best_lr --model_name swin_unetr ... \
        --min_lr 1e-5 --max_lr 5e-3

An exponential sweep of the learning rate from `min_lr` to `max_lr` over
real train steps (the lr set before each step with
`train.optim.set_learning_rate`), starting from the Trainer's fresh state
(`--pretrained` and `--pre_swin` included).  It stops early at a NaN loss
or one above 4x the best so far.  The suggestion is the lr at the
steepest descent of the loss curve smoothed over 3 steps.  Writes
`<default_root_dir>/lr_find/args.json` (the suggestion), `curve.json`
(lrs and losses) and, when matplotlib imports, `plot.pdf`.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..config import Config
from ..data.multi_modal import MultiModalData
from ..train.engine import Trainer
from ..train.optim import set_learning_rate
from . import parse_args


def lr_find(cfg: Config, *, num_steps: int = 100, min_lr: float = 1e-8,
            max_lr: float = 1.0, early_stop_factor: float = 4.0, device=None) -> dict:
    """{"lr": the suggestion, "lrs": each step's lr, "losses": each step's
    loss} of a sweep on `device` (the CUDA card unless given)."""
    data = MultiModalData(cfg)
    trainer = Trainer(cfg, device=device, workdir=cfg.default_root_dir)
    loader = data.train_dataloader()
    state = trainer.fresh_state()
    lrs, losses = [], []
    best = math.inf
    step = 0
    while step < num_steps:
        loader.set_epoch(step)
        for batch in loader:
            if step >= num_steps:
                break
            lr = min_lr * (max_lr / min_lr) ** (step / max(1, num_steps - 1))
            set_learning_rate(state.optimizer, lr)
            state, loss = trainer.train_step(state, batch)
            loss = float(loss)
            lrs.append(lr)
            losses.append(loss)
            best = min(best, loss)
            step += 1
            if math.isnan(loss) or loss > early_stop_factor * best:
                step = num_steps
                break

    # the steepest descent of the smoothed curve (Lightning's suggestion)
    arr = np.asarray(losses)
    if len(arr) > 3:
        smooth = np.convolve(arr, np.ones(3) / 3, mode="valid")
        idx = int(np.argmin(np.gradient(smooth))) + 1
    else:
        idx = int(np.argmin(arr))
    return {"lr": lrs[min(idx, len(lrs) - 1)], "lrs": lrs, "losses": losses}


def main(cfg: Config | None = None, *, device=None, num_steps: int = 100) -> dict:
    if cfg is None:
        cfg, device = parse_args()
    out_dir = Path(cfg.default_root_dir) / "lr_find"
    out_dir.mkdir(parents=True, exist_ok=True)
    result = lr_find(cfg, num_steps=num_steps, min_lr=cfg.min_lr, max_lr=cfg.max_lr,
                     device=device)
    print(f"suggested lr: {result['lr']:.3e}")
    with open(out_dir / "args.json", "w") as f:
        json.dump({"suggested_lr": result["lr"], "model": cfg.model_name}, f)
    with open(out_dir / "curve.json", "w") as f:
        json.dump({"lrs": result["lrs"], "losses": result["losses"]}, f)
    try:
        import matplotlib
    except ImportError:
        return result
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.semilogx(result["lrs"], result["losses"])
    ax.set_xlabel("lr")
    ax.set_ylabel("loss")
    fig.savefig(out_dir / "plot.pdf")
    plt.close(fig)
    return result


if __name__ == "__main__":
    main()
