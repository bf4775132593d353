"""`export` — a checkpoint into a serving bundle (counterpart of
`miseg_tpu/cli/export.py`).

    python -m miseg_tpu_torch.cli.export --model_name swin_unetr ... \
        --ckpt_path experiments/best.pt --export_dir bundles/cswin_fs48 \
        --export_platforms tpu cpu --export_volume_shapes 224x224x224 \
        --export_bake_params --export_check

The bundle (`serve.export_bundle`, version 3) holds the weights in the
compute dtype, the window forward exported with `torch.export`
(`window_fn.pt2`; with `--export_bake_params` also `window_fn_baked.pt2`,
which carries its weights), one volume program's blend tables for each
`--export_volume_shapes` entry (`DxHxW`, served as a captured CUDA graph
on the card), and the meta the server needs, spacing included.
`--export_platforms` names the device types the bundle serves on: `cuda`,
`cpu`, and `tpu`, which the port reads as `cuda`, so JAX's command lines
work unchanged.  The programs are traced on the CPU, so any host exports.
With `--export_check` the bundle is loaded on each of its platforms that
this host has, and its window programs (and the baked one) are held
against the live model, and each volume program against the generic
inferer over the live model (rtol = atol = 2e-2, as in the JAX package).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..inferers import SlidingWindowInferer
from ..models import model_from_config
from ..serve import _window_fn, export_bundle, load_bundle
from ..train.checkpoint import load_any_checkpoint_params
from ..utils.platform import resolve_device
from . import parse_args


def volume_shapes(cfg: Config) -> list[tuple[int, ...]]:
    """`--export_volume_shapes` as spatial shapes, checked as JAX checks
    them."""
    shapes = []
    for s in cfg.export_volume_shapes:
        parts = s.lower().split("x")
        if len(parts) != len(cfg.roi) or not all(p.isdigit() and int(p) > 0 for p in parts):
            raise ValueError(
                f"--export_volume_shapes entry {s!r} must be "
                f"{len(cfg.roi)} positive integers joined by 'x' "
                f"(e.g. {'x'.join(['224'] * len(cfg.roi))})")
        shapes.append(tuple(int(p) for p in parts))
    return shapes


def check_bundle(out, cfg: Config, model, device: torch.device) -> None:
    """Hold the bundle at `out` against the live `model` (on `device`) on
    each of its platforms that this host has, in each window form it
    ships: the served window, and each volume program against the generic
    inferer over the live model."""
    rng = np.random.default_rng(0)
    live = _window_fn(model, torch.float32)
    meta = json.loads((Path(out) / "meta.json").read_text())
    forms = ["arguments", "baked"] if meta["window_baked"] else ["arguments"]
    for platform in meta["platforms"]:
        if platform == "cuda" and not torch.cuda.is_available():
            print("export check: no CUDA device here; the cuda platform is not checked")
            continue
        for form in forms:
            served = load_bundle(out, platform, form=form)
            bs = int(meta["sw_batch_size"])
            window = rng.normal(size=(bs, *cfg.roi, cfg.in_channels)).astype(np.float32)
            mods = np.zeros((bs,), np.int32)
            with torch.inference_mode():
                want = live(torch.from_numpy(window).to(device),
                            torch.from_numpy(mods).to(device)).cpu().numpy()
            got = served(window, mods).cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
            print(f"export check ok on {platform}: {form} window program matches the "
                  f"live model (max abs diff {np.abs(got - want).max():.2e})")
            for entry in meta["volume_programs"]:
                vol = rng.normal(size=(1, *entry["spatial"], cfg.in_channels)
                                 ).astype(np.float32)
                ref = SlidingWindowInferer(live, cfg.roi, bs, entry["overlap"], entry["mode"],
                                           out_channels=cfg.out_channels, device=device)
                want = ref(torch.from_numpy(vol),
                           torch.zeros((1,), dtype=torch.int32)).cpu().numpy()
                if served.volume_program(entry["spatial"], 1, entry["overlap"],
                                         entry["mode"]) is None:
                    raise RuntimeError(f"export check: volume program {entry['tag']} did "
                                       "not load")
                got = served.predict(vol, [0], overlap=entry["overlap"],
                                     mode=entry["mode"]).cpu().numpy()
                np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
                print(f"export check ok on {platform}: volume program {entry['tag']} "
                      f"({form} window) matches the generic inferer over the live model "
                      f"(max abs diff {np.abs(got - want).max():.2e})")


def main(cfg: Config | None = None, *, device=None) -> str:
    if cfg is None:
        cfg, device = parse_args()
    if not (cfg.ckpt_path or cfg.pretrained):
        raise ValueError("provide --ckpt_path (or --pretrained) to export")
    shapes = volume_shapes(cfg)
    device = resolve_device(device, no_gpu=cfg.no_gpu)
    model = model_from_config(cfg, device=device)
    params = load_any_checkpoint_params(cfg.ckpt_path or cfg.pretrained,
                                        model.state_dict(), model_name=cfg.model_name)
    model.load_state_dict(params, strict=True)
    out = export_bundle(cfg, params, cfg.export_dir, platforms=tuple(cfg.export_platforms),
                        volume_shapes=shapes, bake_params=cfg.export_bake_params)
    print(f"exported {cfg.model_name} -> {out} (platforms={list(cfg.export_platforms)}, "
          f"roi={list(cfg.roi)}, spacing={list(cfg.spacing)}"
          + (f", volume programs={shapes}" if shapes else "")
          + (", baked window program" if cfg.export_bake_params else "") + ")")
    if cfg.export_check:
        check_bundle(out, cfg, model, device)
    return str(out)


if __name__ == "__main__":
    main()
