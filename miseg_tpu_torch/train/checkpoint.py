"""Checkpoints in the port's own format (counterpart of
`miseg_tpu/train/checkpoint.py:30,49,69` and `partial_load`,
`miseg_tpu/train/pretrained.py:42`).

A checkpoint is one `torch.save` file of
    {"format": "miseg_tpu_torch", "params": {name: tensor},
     "opt_state": optimizer.state_dict() or {}}
beside a `<path>.json` sidecar holding epoch, best_acc, scheduler and
extra, as the JAX package writes it.  Tensors are saved on the CPU and
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
