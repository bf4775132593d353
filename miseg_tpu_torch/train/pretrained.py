"""Weights from elsewhere merged into a port state dict (counterpart of
`miseg_tpu/train/pretrained.py`).

* `partial_load`: the shape-checked merge of a source state dict into the
  model's, with a report (the reference's `--pretrained` fine-tune load,
  which keeps an output head of another shape at its init,
  networks/utils/utils.py:42-63).
* `load_swin_vit_torch`: `pre_swin_unetr`'s start, MONAI's SSL-pretrained
  `model_swinvit.pt` merged into the model's `swinViT` (utils.py:28-37:
  `module.` stripped, `fc1`/`fc2` renamed `linear1`/`linear2`,
  `strict=False`).  The port is torch already, so its tensors keep their
  layouts; only names change (`layersK.0.blocks.J` -> `layersK.blocks_J`,
  a LayerNorm's `weight` -> `scale`).  At `instance_cond` ViT norms the
  file's `[C]` rows do not fit the `[num_styles, C]` banks: they are
  reported as shape-skipped and kept at init, as the JAX package keeps
  them.

Reading a torch file here unpickles it (`weights_only=False`, as the
JAX package and the reference do): load only files you trust.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

import torch


def load_report(params: Mapping[str, torch.Tensor],
                source: Mapping[str, torch.Tensor]) -> dict[str, list]:
    """What `partial_load(params, source)` does with each name: "loaded"
    (name and shape match), "skipped" ((name, source shape, model shape)),
    "missing" (not in `source`) and "unexpected" (not in `params`)."""
    report = {"loaded": [], "skipped": [], "missing": [], "unexpected": []}
    for name, val in params.items():
        src = source.get(name)
        if src is None:
            report["missing"].append(name)
        elif tuple(src.shape) == tuple(val.shape):
            report["loaded"].append(name)
        else:
            report["skipped"].append((name, tuple(src.shape), tuple(val.shape)))
    report["unexpected"] = [n for n in source if n not in params]
    return report


def partial_load(params: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                 *, verbose: bool = True) -> dict[str, torch.Tensor]:
    """`params` with every tensor replaced by `source`'s wherever the name
    AND the shape match (cast to the target's dtype and device); the rest
    kept, and reported: a checkpoint with another output head loads
    everything but the head."""
    report = load_report(params, source)
    merged = dict(params)
    for name in report["loaded"]:
        merged[name] = source[name].to(device=params[name].device, dtype=params[name].dtype)
    if verbose:
        print(f"partial_load: loaded {len(report['loaded'])}, shape-skipped "
              f"{len(report['skipped'])}, missing {len(report['missing'])}, unexpected "
              f"{len(report['unexpected'])}")
        for name, s, t in report["skipped"]:
            print(f"  skipped {name}: ckpt {s} != model {t} (kept at init)")
    return merged


def read_torch_file(path: str | Path):
    """The object a torch `.pt`/`.ckpt` file holds, on the CPU (unpickled
    with `weights_only=False`: the reference's files hold more than
    tensors)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _torch_state_dict(obj) -> dict[str, torch.Tensor]:
    """A torch file's state dict (its `state_dict` entry when it has one),
    with `module.` stripped and `fc1`/`fc2` renamed `linear1`/`linear2`
    (utils.py:28-37)."""
    sd = obj.get("state_dict", obj) if isinstance(obj, Mapping) else obj
    return {k.replace("module.", "").replace("fc1", "linear1").replace("fc2", "linear2"): v
            for k, v in sd.items()}


_BLOCK = re.compile(r"(layers\d+)\.0\.blocks\.(\d+)\.(norm[12]\.(?:weight|bias)"
                    r"|attn\.relative_position_bias_table|attn\.(?:qkv|proj)\.(?:weight|bias)"
                    r"|mlp\.linear[12]\.(?:weight|bias))")
_DOWNSAMPLE = re.compile(r"(layers\d+)\.0\.(downsample)\.(reduction\.weight|norm\.(?:weight|bias))")


def swin_vit_state_dict(obj) -> dict[str, torch.Tensor]:
    """A MONAI Swin-ViT state dict (`model_swinvit.pt`'s object) under the
    names of the port's `SwinTransformer`, relative to it: the entries the
    JAX package's `_swin_vit_flax_tree` maps (the patch embedding, the
    blocks' norms, attention and MLP, the patch mergings), nothing else;
    a norm's `weight` is its `scale`."""
    sd = {k[len("swinViT."):] if k.startswith("swinViT.") else k: v
          for k, v in _torch_state_dict(obj).items()}
    out = {}
    for key, v in sd.items():
        if key in ("patch_embed.proj.weight", "patch_embed.proj.bias"):
            out[key] = v
        elif m := _BLOCK.fullmatch(key):
            out[_norm_scale(f"{m[1]}.blocks_{m[2]}.{m[3]}")] = v
        elif m := _DOWNSAMPLE.fullmatch(key):
            out[_norm_scale(f"{m[1]}.{m[2]}.{m[3]}")] = v
    return out


def _norm_scale(name: str) -> str:
    return re.sub(r"(norm\d?)\.weight$", r"\1.scale", name)


def load_swin_vit_torch(path: str | Path, params: Mapping[str, torch.Tensor],
                        subtree: str = "swinViT", *,
                        verbose: bool = True) -> dict[str, torch.Tensor]:
    """`params` (a SwinUNETR's state dict) with MONAI's `model_swinvit.pt`
    at `path` merged into its `subtree` entries by `partial_load`'s rule;
    the report covers that subtree only, as the JAX package's does."""
    prefix = subtree + "."
    sub = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
    merged = partial_load(sub, swin_vit_state_dict(read_torch_file(path)), verbose=verbose)
    return {**params, **{prefix + k: v for k, v in merged.items()}}
