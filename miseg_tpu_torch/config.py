"""Configuration: the slice of `miseg_tpu.config.Config` the port reads.

Field names and defaults are those of the JAX package (config.py:24-195),
so a config written for one builds the same model in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


def _lst(*xs):
    return field(default_factory=lambda: list(xs))


@dataclass
class Config:
    # --- model ---
    model_name: str = "unetr"
    in_channels: int = 1
    out_channels: int = 14
    roi_x: int = 96
    roi_y: int = 96
    roi_z: int = 96
    feature_size: list[int] = _lst(16)
    num_heads: int = 12
    spatial_dims: int = 3
    vit_norm_name: str = "layer"
    vit_norm_no_affine: bool = False
    encoder_norm_name: str = "instance"
    encoder_norm_no_affine: bool = False
    decoder_norm_name: str = "instance"
    decoder_norm_no_affine: bool = False
    num_styles: int = 2
    depth_swin_block: list[int] = _lst(2)
    downsample: str = "merging"
    no_normalize_swin: bool = False
    # --- loss (config.py:72-76) ---
    criterion: str = "dice_focal"
    squared_dice: bool = False
    smooth_nr: float = 0.0
    smooth_dr: float = 1e-6
    # --- optimizer (config.py:78-81) ---
    lr: float = 1e-4
    optim_name: str = "adamw"
    reg_weight: float = 1e-5
    momentum: float = 0.99
    # --- inference ---
    infer_overlap: float = 0.5
    sw_batch_size: int = 1
    # --- data (config.py:125) ---
    batch_size: int = 1
    # --- precision / seed ---
    no_amp: bool = False
    precision: str = "bf16"
    seed: int = 0

    @property
    def feature_size_scalar(self) -> int:
        fs = self.feature_size
        return fs[0] if isinstance(fs, (list, tuple)) else int(fs)

    @property
    def roi(self) -> tuple[int, ...]:
        return (self.roi_x, self.roi_y, self.roi_z)[: self.spatial_dims]

    @property
    def amp(self) -> bool:
        return not self.no_amp and self.precision == "bf16"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
