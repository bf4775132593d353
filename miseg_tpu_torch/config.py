"""Configuration: every field of `miseg_tpu.config.Config`.

Field names, types and defaults are those of the JAX package
(config.py:25-204), so `Config(**dataclasses.asdict(jax_cfg))` holds any
JAX config and builds the same model.  `build_parser()` generates the
command line from the fields, as the JAX package's does: the same flags,
and the same argv parses to equal configs in both.

Every field is read: the port has each feature JAX's fields select (the
last, the mesh's compositions, in `parallel.mesh_from_config`, which
takes any axis names, and the Trainer).

`no_gpu` is the reference's flag for a CPU run (its tune group).  The
JAX package accepts it and never reads it, since a JAX process takes its
platform from `JAX_PLATFORMS`; here it selects the CPU exactly as
`--device cpu` does, and beside a CUDA device it raises
(`utils.platform.requested_device`).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field


def _lst(*xs):
    return field(default_factory=lambda: list(xs))


@dataclass
class Config:
    # --- model ---
    pretrained: str | None = None      # checkpoint merged into the model's weights
    ckpt_path: str | None = None       # training checkpoint to resume from
    model_name: str = "unetr"
    in_channels: int = 1
    out_channels: int = 14
    roi_x: int = 96
    roi_y: int = 96
    roi_z: int = 96
    feature_size: list[int] = _lst(16)
    hidden_size: int = 768             # unetr: the ViT's width
    mlp_dim: int = 3072                # unetr: the ViT's MLP width
    num_heads: int = 12
    pos_embed: str = "perceptron"      # unetr: patchify by "perceptron" or "conv"
    no_conv_block: bool = False        # unetr: no conv blocks in the up-projections
    no_res_block: bool = False         # unetr: UnetBasicBlock instead of UnetResBlock
    spatial_dims: int = 3
    qkv_bias: bool = False             # unetr: bias in the ViT's qkv projection
    vit_norm_name: str = "layer"
    vit_norm_no_affine: bool = False
    encoder_norm_name: str = "instance"
    encoder_norm_no_affine: bool = False
    decoder_norm_name: str = "instance"
    decoder_norm_no_affine: bool = False
    num_groups: int = 4                # group norm's groups
    num_styles: int = 2
    dropout_rate: float = 0.0          # after the patch embedding, the projection, the MLP
    attn_drop_rate: float = 0.0        # on the attention probabilities
    dropout_path_rate: float = 0.0     # stochastic depth, linspace over the swin blocks
    depth_swin_block: list[int] = _lst(2)
    use_checkpoint: bool = False       # recompute the swin and conv blocks in the backward
    downsample: str = "merging"
    no_normalize_swin: bool = False
    pre_swin: str = ""                 # pre_swin_unetr: MONAI's model_swinvit.pt
    # --- unet / unet_vanilla (config.py:62-69) ---
    num_layers: int = 4                # unet: levels; channels fs * 2^i, i = 1..num_layers
    strides: list[int] = _lst(2, 2, 2)
    kernel_size: list[int] = _lst(3)
    up_kernel_size: list[int] = _lst(3)
    num_res_units: int = 2
    activation: str = "prelu"
    no_bias: bool = False
    adn_ordering: str = "NDA"
    freeze_encoder: bool = False       # the encoder's parameters get no update
    # --- loss (config.py:72-76) ---
    criterion: str = "dice_focal"
    squared_dice: bool = False
    smooth_nr: float = 0.0
    smooth_dr: float = 1e-6
    no_include_background: bool = False
    # --- optimizer (config.py:78-81) ---
    lr: float = 1e-4
    optim_name: str = "adamw"
    reg_weight: float = 1e-5
    momentum: float = 0.99
    # --- scheduler (config.py:83-88) ---
    scheduler: str = "reduce_on_plateau"
    warmup_epochs: int = 50
    patience_scheduler: int = 3
    t_max: int = 200
    cycles: float = 0.5
    # --- inference ---
    infer_overlap: float = 0.5
    sw_batch_size: int = 1
    infer_cpu: bool = False            # stitch the windows' logits in host memory
    infer_progress: bool = False       # a progress line a window group
    # --- early stop, checkpoints (config.py:96-100) ---
    patience: int = 6
    min_delta: float = 0.001
    save_top_k: int = 3
    # --- logger (config.py:101-106) ---
    experiment_name: str | None = None
    group: str | None = None
    project: str | None = None
    entity: str | None = None
    wandb_mode: str = "online"
    source: int | None = None          # the reference's adversarial stub: unread here and in JAX
    alpha_reversal: float = 1.0        # the ViT head's gradient reversal (config.py:109)
    # --- data (config.py:111-125) ---
    data_dirs: list[str] = _lst("dataset/MM-WHS", "dataset/MM-WHS")
    json_lists: list[str] = _lst("CT_fold1.json", "MR.json")
    space_x: float = 1.0
    space_y: float = 1.0
    space_z: float = 1.0
    patches_training_sample: int = 1
    randFlipd_prob: float = 0.2
    randRotate90d_prob: float = 0.2
    randScaleIntensityd_prob: float = 0.1
    randShiftIntensityd_prob: float = 0.1
    use_normal_dataset: bool = False
    cache_num: int = 24
    loader_workers: int = 8
    batch_size: int = 1
    num_workers: int = 8
    # --- train (config.py:128-141) ---
    study_name: str = "experiment"     # the run's directory; cli.tune's study
    n_trials: int | None = None        # cli.tune: trials to run (None: until the timeout)
    timeout: int | None = None         # cli.tune: seconds after which no trial starts
    max_epochs: int = 2
    check_val_every_n_epoch: int = 1
    no_gpu: bool = False               # run on the CPU (as --device cpu)
    auto_scale_batch_size: bool = False  # double the batch until a step runs out of memory
    iters_to_accumulate: int = 1
    default_root_dir: str = "./experiments"
    port: str = "23456"                # the reference's DDP master port: unread here and in JAX
    storage_name: str = "MI-Seg"       # cli.tune's journal, <default_root_dir>/<name>.journal.jsonl
    min_lr: float = 1e-5               # find_best_lr's sweep
    max_lr: float = 5e-3
    # --- precision / seed ---
    no_amp: bool = False
    precision: str = "bf16"
    seed: int = 0
    # --- parallelism (config.py:145-152) ---
    mesh_shape: list[int] = _lst(-1)
    mesh_axes: list[str] = _lst("data")
    fsdp: bool = False
    fsdp_axis: str = "data"
    fsdp_min_size: int = 8192
    spatial_shard: bool = False
    spatial_axis: str = "sp"
    tensor_parallel: bool = False
    tp_axis: str = "model"
    pipeline_parallel: bool = False
    pp_axis: str = "pp"
    pp_microbatches: int = 2
    # --- export (config.py:153-166); "tpu" among the platforms is read as
    # "cuda" (serve.normalize_platforms) ---
    export_dir: str = "./export_bundle"
    export_platforms: list[str] = _lst("tpu", "cpu")
    export_check: bool = False
    export_volume_shapes: list[str] = _lst()
    export_bake_params: bool = False
    profile_dir: str | None = None     # torch.profiler trace of the second epoch
    log_every_n_steps: int = 10

    @property
    def feature_size_scalar(self) -> int:
        fs = self.feature_size
        return fs[0] if isinstance(fs, (list, tuple)) else int(fs)

    @property
    def roi(self) -> tuple[int, ...]:
        return (self.roi_x, self.roi_y, self.roi_z)[: self.spatial_dims]

    @property
    def spacing(self) -> tuple[float, ...]:
        return (self.space_x, self.space_y, self.space_z)[: self.spatial_dims]

    @property
    def include_background(self) -> bool:
        return not self.no_include_background

    @property
    def amp(self) -> bool:
        return not self.no_amp and self.precision == "bf16"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in known})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _scalar_or_list(v):
    """A one-element list as its element (a kernel size for every axis)."""
    if isinstance(v, (list, tuple)) and len(v) == 1:
        return v[0]
    return v


def build_parser(parser: argparse.ArgumentParser | None = None) -> argparse.ArgumentParser:
    """An argparse command line generated from `Config`'s fields, one
    `--<field>` flag each (the JAX package's rules: bools are store_true,
    lists take one or more values, None defaults are typed by annotation)."""
    parser = parser or argparse.ArgumentParser(description="miseg_tpu_torch")
    for f in dataclasses.fields(Config):
        flag = f"--{f.name}"
        if f.type == "bool" or f.type is bool:
            parser.add_argument(flag, action="store_true", default=f.default)
        elif f.default_factory is not dataclasses.MISSING:  # list field
            default = f.default_factory()
            elem = type(default[0]) if default else str
            parser.add_argument(flag, nargs="+", type=elem, default=default)
        else:
            typ = {int: int, float: float, str: str}.get(type(f.default), str)
            if f.default is None:
                typ = int if "int" in str(f.type) else str
            parser.add_argument(flag, type=typ, default=f.default)
    return parser


def parse_config(argv: list[str] | None = None) -> Config:
    return Config.from_args(build_parser().parse_args(argv))
