"""Checkpoints in the port's own format (counterpart of
`miseg_tpu/train/checkpoint.py:30,49,69,81` and `partial_load`,
`miseg_tpu/train/pretrained.py:42`), and the top-k + last manager.

A checkpoint is one `torch.save` file of
    {"format": "miseg_tpu_torch", "params": {name: tensor},
     "opt_state": the trainer's optimizer state or {}}
beside a `<path>.json` sidecar holding epoch, best_acc, scheduler and
extra, as the JAX package writes it.  "params" is the model's whole
state dict: its parameters and its buffers (a batch norm's f32 running
`mean`/`var`, which the JAX package's msgpack checkpoints drop: ROADMAP
W9).  Tensors are saved on the CPU and
read back with `weights_only=True`.  The JAX package's msgpack
checkpoints and the reference's torch `.pt`/`.ckpt` files are not read
here: the reference ingest is ROADMAP's M8.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from pathlib import Path

import torch

FORMAT = "miseg_tpu_torch"


def save_checkpoint(path: str | Path, *, params: Mapping[str, torch.Tensor],
                    opt_state: dict | None = None, epoch: int = 0,
                    best_acc: float = 0.0, scheduler_state: dict | None = None,
                    extra: dict | None = None) -> None:
    """Write `params` (a state dict) and, when given, `opt_state` (an
    optimizer's `state_dict()`) to `path`, and the sidecar beside it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"format": FORMAT,
               "params": {k: v.detach().cpu() for k, v in params.items()},
               "opt_state": opt_state or {}}
    torch.save(payload, path)
    meta = {"epoch": epoch, "best_acc": float(best_acc),
            "scheduler": scheduler_state or {}, "extra": extra or {}}
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str | Path) -> dict:
    """{"params", "opt_state", and the sidecar's keys} of a port checkpoint.
    Raises ValueError for any other file."""
    path = Path(path)
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch.load raises many kinds on foreign bytes
        raise ValueError(
            f"{path} is not a {FORMAT} checkpoint ({type(e).__name__}); the JAX "
            "package's msgpack and the reference's torch checkpoints are read by "
            "the checkpoint ingest of ROADMAP M8, not ported yet") from e
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(
            f"{path} is not a {FORMAT} checkpoint; the reference's torch .pt/.ckpt "
            "files are read by the checkpoint ingest of ROADMAP M8, not ported yet")
    meta = {}
    if os.path.exists(str(path) + ".json"):
        with open(str(path) + ".json") as f:
            meta = json.load(f)
    return {"params": payload["params"], "opt_state": payload.get("opt_state") or None,
            **meta}


def partial_load(params: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                 *, verbose: bool = True) -> dict[str, torch.Tensor]:
    """`params` with every tensor replaced by `source`'s wherever the name
    AND the shape match (cast to the target's dtype and device); the rest
    kept, and reported: a checkpoint with another output head loads
    everything but the head."""
    loaded, skipped, missing = [], [], []
    merged = {}
    for name, val in params.items():
        src = source.get(name)
        if src is None:
            merged[name] = val
            missing.append(name)
        elif tuple(src.shape) == tuple(val.shape):
            merged[name] = src.to(device=val.device, dtype=val.dtype)
            loaded.append(name)
        else:
            merged[name] = val
            skipped.append((name, tuple(src.shape), tuple(val.shape)))
    unexpected = [n for n in source if n not in params]
    if verbose:
        print(f"partial_load: loaded {len(loaded)}, shape-skipped {len(skipped)}, "
              f"missing {len(missing)}, unexpected {len(unexpected)}")
        for name, s, t in skipped:
            print(f"  skipped {name}: ckpt {s} != model {t} (kept at init)")
    return merged


def load_any_checkpoint_params(path: str | Path,
                               params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Merge the port checkpoint at `path` into the state dict `params`
    (`partial_load`'s rule)."""
    return partial_load(params, load_checkpoint(path)["params"])


class CheckpointManager:
    """The top-k checkpoints by a monitored metric, and `last.ckpt`, in one
    directory (counterpart of `miseg_tpu/train/checkpoint.py:81-156`).

    The top-k record lives in `manager.json` beside them and is read back
    on construction, so `best_path` and the pruning of stale files survive
    a resume (PTL ModelCheckpoint's persisted state).
    """

    def __init__(self, directory: str | Path, monitor: str = "val/accuracy/avg",
                 mode: str = "max", save_top_k: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self._topk: list[tuple[float, str]] = []
        self._restore_state()

    @property
    def _state_path(self) -> Path:
        return self.dir / "manager.json"

    def _restore_state(self) -> None:
        if not self._state_path.exists():
            return
        try:
            with open(self._state_path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        # A sidecar recorded under a DIFFERENT monitored metric or mode is
        # incomparable — start the top-k record fresh rather than ranking
        # mixed metrics against each other.
        if (state.get("monitor", self.monitor) != self.monitor
                or state.get("mode", self.mode) != self.mode):
            print(f"CheckpointManager: discarding persisted top-k recorded "
                  f"for monitor={state.get('monitor')!r}/mode="
                  f"{state.get('mode')!r} (now {self.monitor!r}/{self.mode!r})")
            return
        # Keep only entries whose checkpoint files still exist on disk.
        self._topk = [(float(m), p) for m, p in state.get("topk", [])
                      if os.path.exists(p)]

    def _persist_state(self) -> None:
        tmp = str(self._state_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"monitor": self.monitor, "mode": self.mode,
                       "topk": self._topk}, f)
        os.replace(tmp, self._state_path)

    @property
    def best_path(self) -> str | None:
        if not self._topk:
            return None
        best = max(self._topk) if self.mode == "max" else min(self._topk)
        return best[1]

    def save(self, metric: float, *, params: Mapping[str, torch.Tensor],
             opt_state: dict | None = None, epoch: int = 0,
             scheduler_state: dict | None = None, extra: dict | None = None) -> None:
        name = f"epoch{epoch:05d}-{metric:.4f}.ckpt"
        path = self.dir / name
        save_checkpoint(path, params=params, opt_state=opt_state, epoch=epoch,
                        best_acc=metric, scheduler_state=scheduler_state,
                        extra=extra)
        self._topk.append((metric, str(path)))
        reverse = self.mode == "max"
        self._topk.sort(key=lambda t: t[0], reverse=reverse)
        while len(self._topk) > self.save_top_k:
            _, drop = self._topk.pop()
            for p in (drop, drop + ".json"):
                if os.path.exists(p):
                    os.remove(p)
        save_checkpoint(self.dir / "last.ckpt", params=params,
                        opt_state=opt_state, epoch=epoch, best_acc=metric,
                        scheduler_state=scheduler_state, extra=extra)
        self._persist_state()
