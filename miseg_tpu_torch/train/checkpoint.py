"""Checkpoints in the port's own format (counterpart of
`miseg_tpu/train/checkpoint.py:30,49,69,81`), the ingest of every other
checkpoint a user brings, and the top-k + last manager.

A port checkpoint is one `torch.save` file of
    {"format": "miseg_tpu_torch", "params": {name: tensor},
     "opt_state": the trainer's optimizer state or {}}
beside a `<path>.json` sidecar holding epoch, best_acc, scheduler and
extra, as the JAX package writes it.  "params" is the model's whole
state dict: its parameters and its buffers (a batch norm's f32 running
`mean`/`var`, which the JAX package's msgpack checkpoints drop: ROADMAP
W9).  Tensors are saved on the CPU and read back with
`weights_only=True`.

`load_any_checkpoint_params` reads three formats, told apart by the
file's own bytes (`checkpoint_format`), never by trying one reader after
another: a port checkpoint; a JAX package checkpoint (flax msgpack,
read by `flax_msgpack` and bridged by `weights.state_dict_from_jax`);
a torch `.pt`/`.ckpt` in the reference's naming (`ref_import`).
"""

from __future__ import annotations

import json
import os
import pickletools
import zipfile
from collections.abc import Mapping
from pathlib import Path

import torch

from ..nn.norms import RUNNING_STATS
from ..weights import state_dict_from_jax
from .flax_msgpack import msgpack_restore
from .pretrained import partial_load
from .ref_import import load_reference_checkpoint

FORMAT = "miseg_tpu_torch"
FORMATS = ("a miseg_tpu_torch checkpoint (torch zip with format 'miseg_tpu_torch')",
           "a JAX package checkpoint (flax msgpack)",
           "a reference PyTorch/Lightning .pt/.ckpt file (torch zip or pickle)")


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


def _is_port_zip(path: Path) -> bool:
    """Whether a torch zip file's pickle starts its top-level dict with
    `"format": FORMAT`, read from the pickle's opcodes without running it."""
    with zipfile.ZipFile(path) as z:
        pkl = next((n for n in z.namelist() if n.endswith("/data.pkl")), None)
        if pkl is None:
            return False
        strings = [arg for op, arg, _ in pickletools.genops(z.read(pkl))
                   if isinstance(arg, str) and "UNICODE" in op.name]
    return strings[:2] == ["format", FORMAT]


def checkpoint_format(path: str | Path) -> str:
    """"port", "flax" or "torch", from the file's first bytes: a torch zip
    (`PK`) is the port's when its pickle says so, else the reference's; a
    pickle (`\\x80`, torch's legacy format) is the reference's; a msgpack
    map (0x81..0x8f, 0xde, 0xdf) is flax's.  Anything else raises."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "port" if _is_port_zip(path) else "torch"
    if head[:1] == b"\x80":
        return "torch"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "flax"
    raise ValueError(f"{path} is none of the checkpoint formats the port reads: "
                     + "; ".join(FORMATS))


def load_checkpoint(path: str | Path) -> dict:
    """{"params", "opt_state", and the sidecar's keys} of a port checkpoint.
    Raises ValueError for any other file: `load_any_checkpoint_params`
    reads the others' weights."""
    path = Path(path)
    if checkpoint_format(path) != "port":
        raise ValueError(f"{path} is not a {FORMAT} checkpoint; merge its weights with "
                         "load_any_checkpoint_params")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if os.path.exists(str(path) + ".json"):
        with open(str(path) + ".json") as f:
            meta = json.load(f)
    return {"params": payload["params"], "opt_state": payload.get("opt_state") or None,
            **meta}


def load_any_checkpoint_params(path: str | Path, params: Mapping[str, torch.Tensor], *,
                               model_name: str) -> dict[str, torch.Tensor]:
    """Merge the checkpoint at `path` into the state dict `params` of a
    `model_name` model (`partial_load`'s rule), whichever of the three
    formats it is.  A foreign file's optimizer state is not restored (the
    JAX package merges params only), and a JAX file of a batch-norm model
    holds no running statistics (W9): its `mean`/`var` stay at their init
    (0 and 1), which is what JAX's `cli.test` evaluates with.  Both are
    printed."""
    kind = checkpoint_format(path)
    if kind == "port":
        return partial_load(params, load_checkpoint(path)["params"])
    if kind == "torch":
        merged = load_reference_checkpoint(path, model_name, params)
        print(f"{path}: a reference checkpoint; its optimizer state, if any, is not restored")
        return merged
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if not isinstance(payload, dict) or not isinstance(payload.get("params"), dict):
        raise ValueError(f"{path} is a msgpack file without the JAX package's 'params'")
    merged = partial_load(params, state_dict_from_jax(payload["params"]))
    if payload.get("opt_state"):
        print(f"{path}: the JAX checkpoint's optimizer state is not restored")
    stats = [n for n in params if n.rsplit(".", 1)[-1] in RUNNING_STATS]
    if stats:
        print(f"{path}: a JAX checkpoint holds no batch-norm running statistics (W9); "
              f"{len(stats)} buffers stay at their init (mean 0, var 1)")
    return merged


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
