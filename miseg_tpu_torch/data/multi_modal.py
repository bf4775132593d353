"""The CT + MR data module (counterpart of `miseg_tpu/data/multi_modal.py`):
  * `train_transforms`: load, channel-last, RAS, resample to the
    configured spacing (bilinear image, nearest label), min-max scale, pad
    to the ROI, the foreground/background index pools (cached), then the
    random tail: `patches_training_sample` class-balanced ROI crops
    (pos 1 : neg 1), a flip per axis, a rot90 and the intensity scale and
    shift;
  * `eval_transforms`: the same deterministic prefix, whole volume;
  * `MultiModalData`: one dataset per modality JSON (a `CacheDataset`
    unless `use_normal_dataset`), concatenated; the train loader shuffles
    (interleaving CT and MR), val and test run at batch 1;
  * `get_loaders`: the raw loop's loader factory.
"""

from __future__ import annotations

import os

from ..config import Config
from . import transforms as T
from .datalist import load_decathlon_datalist_with_modality
from .dataset import CacheDataset, ConcatDataset, DataLoader, Dataset


def train_transforms(cfg: Config) -> T.Compose:
    roi = cfg.roi
    return T.Compose([
        T.LoadImaged(keys=["image", "label"]),
        T.EnsureChannelLastd(keys=["image", "label"]),
        T.Orientationd(keys=["image", "label"], axcodes="RAS"),
        T.Spacingd(keys=["image", "label"], pixdim=cfg.spacing,
                   mode=("bilinear", "nearest")),
        T.ScaleIntensityd(keys=["image"]),
        T.SpatialPadd(keys=["image", "label"], spatial_size=roi, value=0),
        T.FgBgToIndicesd(keys=["label"], image_key="image", image_threshold=0),
        T.RandCropByPosNegLabeld(keys=["image", "label"], label_key="label",
                                 spatial_size=roi, pos=1, neg=1,
                                 num_samples=cfg.patches_training_sample,
                                 image_key="image", image_threshold=0),
        T.RandFlipd(keys=["image", "label"], prob=cfg.randFlipd_prob, spatial_axis=0),
        T.RandFlipd(keys=["image", "label"], prob=cfg.randFlipd_prob, spatial_axis=1),
        T.RandFlipd(keys=["image", "label"], prob=cfg.randFlipd_prob, spatial_axis=2),
        T.RandRotate90d(keys=["image", "label"], prob=cfg.randRotate90d_prob, max_k=3),
        T.RandScaleIntensityd(keys=["image"], factors=0.1,
                              prob=cfg.randScaleIntensityd_prob),
        T.RandShiftIntensityd(keys=["image"], offsets=0.1,
                              prob=cfg.randShiftIntensityd_prob),
        T.ToTensord(keys=["image", "label"]),
    ])




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


class MultiModalData:
    """Builds the per-split datasets/loaders for all modality JSONs."""

    def __init__(self, cfg: Config, *, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.datalist_jsons = [os.path.join(d, j)
                               for d, j in zip(cfg.data_dirs, cfg.json_lists)]

    def _datasets(self, key: str, transform: T.Compose) -> list[Dataset]:
        cfg = self.cfg
        out = []
        for json_path, base_dir in zip(self.datalist_jsons, cfg.data_dirs):
            items = load_decathlon_datalist_with_modality(
                json_path, True, key, base_dir=base_dir)
            if not items:
                continue
            if cfg.use_normal_dataset:
                out.append(Dataset(items, transform))
            else:
                out.append(CacheDataset(items, transform,
                                        cache_num=cfg.cache_num, cache_rate=1.0,
                                        num_workers=cfg.loader_workers))
        return out

    def train_dataloader(self) -> DataLoader:
        ds = ConcatDataset(self._datasets("training", train_transforms(self.cfg)))
        return DataLoader(ds, batch_size=self.cfg.batch_size, shuffle=True,
                          seed=self.cfg.seed, num_workers=self.cfg.num_workers,
                          shard=self.shard, num_shards=self.num_shards)

    def val_dataloader(self) -> DataLoader:
        ds = ConcatDataset(self._datasets("validation", eval_transforms(self.cfg)))
        # whole-volume evaluation at batch 1
        return DataLoader(ds, batch_size=1, shuffle=False,
                          num_workers=self.cfg.num_workers)

    def test_dataloader(self) -> DataLoader:
        ds = ConcatDataset(self._datasets("test", eval_transforms(self.cfg)))
        return DataLoader(ds, batch_size=1, shuffle=False,
                          num_workers=self.cfg.num_workers)


def get_loaders(cfg: Config, *, test_mode: bool = False, shard: int = 0,
                num_shards: int = 1):
    """The train and val loaders, or with `test_mode` the test loader."""
    dm = MultiModalData(cfg, shard=shard, num_shards=num_shards)
    if test_mode:
        return dm.test_dataloader()
    return dm.train_dataloader(), dm.val_dataloader()
