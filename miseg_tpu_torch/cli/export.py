"""`export` — a checkpoint into a serving bundle (counterpart of
`miseg_tpu/cli/export.py`).

    python -m miseg_tpu_torch.cli.export --model_name swin_unetr ... \
        --ckpt_path experiments/best.pt --export_dir bundles/cswin_fs48 \
        --export_check

The bundle (`serve.save_bundle`) holds the weights in the compute dtype
and the meta the server needs, spacing included.  With `--export_check`
the loaded bundle's window forward is held against the live f32 model
(rtol = atol = 2e-2, as in the JAX package).  The JAX package's
platforms, volume programs and baked programs have no counterpart here:
`--export_platforms` must keep JAX's default (which this export does not
read), and `--export_volume_shapes` / `--export_bake_params` must stay
unset, else it raises `NotImplementedError` (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, require_ported
from ..models import model_from_config
from ..serve import load_bundle, save_bundle
from ..train.checkpoint import load_any_checkpoint_params
from ..utils.platform import resolve_device
from . import parse_args


def main(cfg: Config | None = None, *, device=None) -> str:
    if cfg is None:
        cfg, device = parse_args()
    require_ported(cfg, "M12", "cli.export")
    if not (cfg.ckpt_path or cfg.pretrained):
        raise ValueError("provide --ckpt_path (or --pretrained) to export")
    device = resolve_device(device, no_gpu=cfg.no_gpu)
    model = model_from_config(cfg, device=device)
    params = load_any_checkpoint_params(cfg.ckpt_path or cfg.pretrained,
                                        model.state_dict(), model_name=cfg.model_name)
    model.load_state_dict(params, strict=True)
    out = save_bundle(cfg, params, cfg.export_dir)
    print(f"exported {cfg.model_name} -> {out} (roi={list(cfg.roi)}, "
          f"spacing={list(cfg.spacing)})")

    if cfg.export_check:
        served = load_bundle(out, device)
        bs = int(served.meta["sw_batch_size"])
        window = np.random.default_rng(0).normal(
            size=(bs, *cfg.roi, cfg.in_channels)).astype(np.float32)
        mods = np.zeros((bs,), np.int32)
        got = served(window, mods).cpu().numpy()
        with torch.inference_mode():
            want = model(torch.from_numpy(window).to(device),
                         torch.from_numpy(mods).to(device)).float().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        print(f"export check ok: bundle forward matches live model "
              f"(max abs diff {np.abs(got - want).max():.2e})")
    return str(out)


if __name__ == "__main__":
    main()
