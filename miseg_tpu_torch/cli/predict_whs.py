"""`predict_whs` — segmentations as NIfTI in each scan's own voxel grid
(counterpart of `miseg_tpu/cli/predict_whs.py`).

    python -m miseg_tpu_torch.cli.predict_whs --model_name swin_unetr ... \
        --ckpt_path experiments/best.pt --data_dirs dataset/MM-WHS \
        --json_lists CT_test.json

For every scan of the datalist's "test" split: the deterministic chain
(`eval_transforms`, with the image also loaded as "label" to record the
invertible ops) -> sliding-window logits on the device (constant blend)
-> argmax -> `Compose.inverse` (unpad, resample back with nearest,
reorient) -> MM-WHS label values -> `save_nifti` with the scan's
original affine.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data.datalist import load_decathlon_datalist_with_modality
from ..data.multi_modal import eval_transforms
from ..data.nifti import save_nifti
from ..train.checkpoint import load_any_checkpoint_params
from ..train.engine import Trainer
from . import parse_args

# MM-WHS ground-truth label values by class id
MMWHS_LABEL_MAP = {1: 500, 2: 600, 3: 420, 4: 550, 5: 205, 6: 820, 7: 850}


def remap_labels(pred: np.ndarray, mapping: dict[int, int] = MMWHS_LABEL_MAP) -> np.ndarray:
    out = np.zeros_like(pred, dtype=np.uint16)
    for src, dst in mapping.items():
        out[pred == src] = dst
    return out


def main(cfg: Config | None = None, *, result_dir: str | None = None,
         data_dir: str | None = None, json_list: str | None = None,
         device=None) -> list[str]:
    """Write one `*label*` NIfTI per test scan into `result_dir` (default
    `<default_root_dir>/predictions`); returns their paths."""
    if cfg is None:
        cfg, device = parse_args()
    result_dir = result_dir or os.path.join(cfg.default_root_dir, "predictions")
    data_dir = data_dir or cfg.data_dirs[0]
    json_list = json_list or cfg.json_lists[0]

    trainer = Trainer(cfg, device=device)
    params = None
    if cfg.ckpt_path or cfg.pretrained:
        params = load_any_checkpoint_params(cfg.ckpt_path or cfg.pretrained,
                                            trainer.model.state_dict(),
                                            model_name=cfg.model_name)
    trainer.init_state(params)
    inferer = trainer.make_inferer()

    tr = eval_transforms(cfg, allow_missing_keys=True)
    datalist = load_decathlon_datalist_with_modality(
        os.path.join(data_dir, json_list), True, "test", base_dir=data_dir)
    Path(result_dir).mkdir(parents=True, exist_ok=True)

    written = []
    for el in datalist:
        # "label" = the image records the ops that invert the prediction
        sample_d = tr({"image": el["image"], "label": el["image"]})
        image = torch.from_numpy(np.ascontiguousarray(sample_d["image"]))[None]
        modality = torch.tensor([el["modality"]], dtype=torch.int32)
        with torch.inference_mode():
            logits = inferer(image, modality)
            pred = logits[0].argmax(dim=-1).to(torch.int32).cpu().numpy()

        inv_d = dict(sample_d)
        inv_d["label"] = pred[..., None].astype(np.float32)
        inverted = tr.inverse(inv_d, key="label")
        final = remap_labels(np.rint(np.asarray(inverted["label"])).astype(np.int32))

        original_affine = sample_d["image_meta"]["original_affine"]
        img_name = os.path.basename(sample_d["image_meta"]["filename_or_obj"])
        out_path = os.path.join(result_dir, img_name.replace("image", "label"))
        save_nifti(out_path, final.astype(np.uint16), original_affine)
        written.append(out_path)
        print(f"wrote {out_path}")
    return written


if __name__ == "__main__":
    main()
