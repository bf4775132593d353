"""Serving bundles (counterpart of `miseg_tpu/serve.py:76-89,206-361`).

A port bundle is a directory:
    meta.json    roi / channels / overlap / spacing / dtypes / the model
                 config — everything the serving side needs to rebuild
                 the model and its preprocessing chain (version 2; a
                 version-1 bundle has no spacing, and the HTTP server's
                 chain refuses it)
    weights.pt   the state dict, saved with `torch.save` in the compute
                 dtype (bf16 under amp), but for a batch norm's running
                 statistics, which stay f32 (the JAX package's bundles
                 drop them: ROADMAP W9)

`ServedModel.predict` runs gaussian (or constant) sliding-window inference
over a whole volume with the window forward of `_window_fn`: bf16 weights
and inputs under amp, f32 logits.  The JAX package's StableHLO artifacts,
volume programs and baked programs have no counterpart here.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .config import Config
from .inferers import SlidingWindowInferer
from .models import buffer_names, model_from_config
from .utils.platform import resolve_device

_BUNDLE_VERSION = 2
_META_FILE = "meta.json"
_WEIGHTS_FILE = "weights.pt"


def _compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.amp else torch.float32


def _window_fn(model, compute_dtype: torch.dtype):
    """(window, modalities) -> f32 logits, with the model's weights already
    in `compute_dtype`."""

    def fn(window, modalities):
        return model(window.to(compute_dtype), modalities).float()

    return fn


def save_bundle(cfg: Config, state_dict: dict, out_dir: str | Path) -> Path:
    """Write `cfg`'s model weights `state_dict` as a serving bundle."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    compute = _compute_dtype(cfg)
    buffers = buffer_names(cfg)
    weights = {k: (v.detach().to("cpu", compute)
                   if v.is_floating_point() and k not in buffers
                   else v.detach().cpu()) for k, v in state_dict.items()}
    torch.save(weights, out / _WEIGHTS_FILE)
    meta = {
        "bundle_version": _BUNDLE_VERSION,
        "roi": list(cfg.roi),
        "in_channels": int(cfg.in_channels),
        "out_channels": int(cfg.out_channels),
        "sw_batch_size": int(cfg.sw_batch_size),
        "infer_overlap": float(cfg.infer_overlap),
        "spacing": [float(s) for s in cfg.spacing],
        "compute_dtype": str(compute).removeprefix("torch."),
        "params_dtype": str(compute).removeprefix("torch."),
        "torch_version": torch.__version__,
        "model_name": cfg.model_name,
        "config": cfg.to_dict(),
    }
    (out / _META_FILE).write_text(json.dumps(meta, indent=2))
    return out


class ServedModel:
    """A loaded bundle: window-level `__call__` and volume-level `predict`."""

    def __init__(self, model: torch.nn.Module, meta: dict, device):
        self.model = model
        self.meta = meta
        self.device = torch.device(device)
        self.compute_dtype = getattr(torch, meta["compute_dtype"])
        self._window = _window_fn(model, self.compute_dtype)
        self._inferers: dict = {}

    @torch.inference_mode()
    def __call__(self, window, modalities):
        return self._window(torch.as_tensor(window, device=self.device),
                            torch.as_tensor(modalities, dtype=torch.int32,
                                            device=self.device))

    def predict(self, volume, modalities, *, overlap: float | None = None,
                mode: str = "gaussian") -> torch.Tensor:
        """Sliding-window inference over `volume [B, *spatial, Cin]`;
        returns f32 logits `[B, *spatial, out_channels]` on the device."""
        ov = float(self.meta["infer_overlap"] if overlap is None else overlap)
        key = (ov, mode)
        if key not in self._inferers:
            self._inferers[key] = SlidingWindowInferer(
                self._window, roi_size=tuple(self.meta["roi"]),
                sw_batch_size=int(self.meta["sw_batch_size"]), overlap=ov,
                mode=mode, out_channels=int(self.meta["out_channels"]),
                device=self.device)
        mods = torch.as_tensor(modalities, dtype=torch.int32, device=self.device)
        return self._inferers[key](
            torch.as_tensor(volume, dtype=torch.float32, device=self.device), mods)


def load_bundle(bundle_dir: str | Path, device=None) -> ServedModel:
    """Load a serving bundle onto `device` (the CUDA card unless given)."""
    device = resolve_device(device)
    d = Path(bundle_dir)
    meta = json.loads((d / _META_FILE).read_text())
    if meta.get("bundle_version", 0) > _BUNDLE_VERSION:
        raise ValueError(f"bundle version {meta['bundle_version']} is newer "
                         f"than this runtime supports ({_BUNDLE_VERSION})")
    cfg = Config(**meta["config"])
    model = model_from_config(cfg, device=device,
                              dtype=getattr(torch, meta["params_dtype"]))
    state = torch.load(d / _WEIGHTS_FILE, map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return ServedModel(model.eval(), meta, device)
