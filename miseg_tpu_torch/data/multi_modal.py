"""The evaluation preprocessing chain of `miseg_tpu/data/multi_modal.py:55`
(`eval_transforms`): load, channel-last, RAS, resample to the configured
spacing (bilinear image, nearest label), min-max scale, pad to the ROI.
Datasets, loaders and the training chain are not ported yet."""

from __future__ import annotations

from ..config import Config
from . import transforms as T


def eval_transforms(cfg: Config, allow_missing_keys: bool = False) -> T.Compose:
    return T.Compose([
        T.LoadImaged(keys=["image", "label"], allow_missing_keys=allow_missing_keys),
        T.EnsureChannelLastd(keys=["image", "label"],
                             allow_missing_keys=allow_missing_keys),
        T.Orientationd(keys=["image", "label"], axcodes="RAS",
                       allow_missing_keys=allow_missing_keys),
        T.Spacingd(keys=["image", "label"], pixdim=cfg.spacing,
                   mode=("bilinear", "nearest"),
                   allow_missing_keys=allow_missing_keys),
        T.ScaleIntensityd(keys=["image"]),
        T.SpatialPadd(keys=["image", "label"], spatial_size=cfg.roi, value=0,
                      allow_missing_keys=allow_missing_keys),
        T.ToTensord(keys=["image", "label"]),
    ])
