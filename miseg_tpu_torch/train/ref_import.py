"""The reference's own checkpoints (PyTorch `.pt` and Lightning `.ckpt`
files of the five models) under the port's names (counterpart of
`miseg_tpu/train/ref_import.py` and of `miseg_tpu/train/torch_import.py`).

The JAX package has two translators for these files, and they disagree on
transposed convolutions (ROADMAP W10): `ref_import._convT_kernel` flips a
ConvTranspose kernel's spatial axes, which `lax.conv_transpose(...,
transpose_kernel=False)` needs and the golden tests of the reference's
nets confirm (tests/test_full_model_parity.py); `torch_import._deconv_kernel`
does not flip, and `load_any_checkpoint_params`, so JAX's `cli.test`,
`predict_whs`, `export` and `--pretrained`, go through it.  The port has
one translator, this one, and no flip at all: the port is torch, so every
tensor keeps the reference's layout, and a reference ConvTranspose weight
`[I, O, *k]` is what `F.conv_transpose3d` takes.  Only names change:

  * a leading `module.` (DDP), then Lightning's `model.` prefix, are
    stripped, but never the recursive UNet's own root `model.<digit>` nor
    its `submodule.`s (the JAX package's file reader,
    `pretrained._torch_state_dict`, removes `module.` anywhere and so
    turns C-UNet's `1.submodule.0` into `1.sub0`: W10); `fc1`/`fc2` are
    `linear1`/`linear2`;
  * swin stages `layersK.0` -> `layersK`, block lists `blocks.J` ->
    `blocks_J` (Swin-ViT and ViT);
  * UNETR's progressive up-projections `encoderN.blocks.I.0` (or
    `.blocks.I.conv` without conv blocks) -> `upI`, `encoderN.blocks.I.1`
    -> `blockI`; `attn.out_proj` -> `attn.proj`; the perceptron patch
    embedding's Sequential index `patch_embeddings.1` is dropped;
  * the recursive UNet's `0` / `1.submodule` / `2.0` / `2.1` -> `down` /
    `sub` (or `bottom` at the deepest level) / `up` / `up_ru`;
    UNetVanilla's `down_path.I.J` -> `down_path_I_J`, `up_path.I.1` ->
    `up_path_I`; a ResidualUnit's `conv.unitN` -> `unitN`;
  * a transposed conv's `.conv` wrapper is dropped (`transp_conv.conv.weight`
    -> `transp_conv.weight`, likewise `transp_conv_init`, `upI` and
    C-UNet's `up`);
  * conditional-norm rows `X.norms.S.{weight,bias}` are stacked into the
    `[num_styles, C]` banks `X.scale`/`X.bias`; any other 1-D `weight` is
    a norm's `scale`, or under an ADN's `A` a PReLU's `slope`;
  * batch norm's `running_mean`/`running_var` land in the port's `mean`/
    `var` buffers (the JAX package has no place for them: ROADMAP W9);
    `num_batches_tracked` and `relative_position_index` are dropped.

Reading a file unpickles it (`weights_only=False`, as the JAX package and
the reference do): load only files you trust.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

import torch

from ..models.factory import MODEL_NAMES
from ..weights import _is_transposed
from .pretrained import partial_load, read_torch_file

_UNIT = re.compile(r"unit\d+")
_LAYERS = re.compile(r"layers\d+")
_BANK = re.compile(r"(.*)\.norms\.(\d+)\.(weight|bias)")
_DROPPED = ("relative_position_index", "num_batches_tracked")
_BUFFERS = {"running_mean": "mean", "running_var": "var"}


def _module_path(dotted: str) -> list[str]:
    """A reference module path -> the port's module path, as a list."""
    toks = dotted.split(".")
    out: list[str] = []
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        nxt = toks[i + 1] if i + 1 < n else ""
        after = toks[i + 2] if i + 2 < n else ""
        if t == "conv" and _UNIT.fullmatch(nxt):          # ResidualUnit's Sequential
            i += 1
        elif t == "conv" and i == n - 1 and out and _is_transposed(out[-1]):
            i += 1                                         # a transposed conv's wrapper
        elif _LAYERS.fullmatch(t) and nxt == "0":          # a swin stage's Sequential
            out.append(t)
            i += 2
        elif t == "blocks" and nxt.isdigit() and after in ("0", "1", "conv") \
                and out and out[-1].startswith("encoder"):  # UnetrPrUpBlock
            out.append(f"block{nxt}" if after == "1" else f"up{nxt}")
            i += 2 if after == "conv" else 3
        elif t == "blocks" and nxt.isdigit():               # swin and ViT block lists
            out.append(f"blocks_{nxt}")
            i += 2
        elif t == "out_proj":
            out.append("proj")
            i += 1
        elif t == "patch_embeddings" and nxt == "1":       # perceptron: (Rearrange, Linear)
            out.append(t)
            i += 2
        elif t == "down_path" and nxt.isdigit() and after.isdigit():
            out.append(f"down_path_{nxt}_{after}")
            i += 3
        elif t == "up_path" and nxt.isdigit() and after == "1":
            out.append(f"up_path_{nxt}")                   # index 0 is the Upsample
            i += 3
        elif t.isdigit() and out and out[-1] in ("model", "sub"):  # the recursive UNet
            if t == "1":                                   # SkipConnection(submodule)
                i += 2 if nxt == "submodule" else 1
                out.append("sub" if i < n and toks[i].isdigit() else "bottom")
            else:
                out.append("down" if t == "0" else "up")
                i += 1
        elif t.isdigit() and out and out[-1] == "up":      # up = (transposed conv, unit)
            if t == "1":
                out[-1] = "up_ru"
            i += 1
        else:
            out.append(t)
            i += 1
    return out


def _leaf(path: list[str], leaf: str, value: torch.Tensor) -> str:
    if leaf in _BUFFERS:
        leaf = _BUFFERS[leaf]
    elif leaf == "weight" and value.ndim == 1:
        leaf = "slope" if path and path[-1] == "A" else "scale"
    return ".".join([*path, leaf])


def _strip_prefixes(key: str) -> str:
    # only a leading `module.`: C-UNet's own keys hold `submodule.`
    key = re.sub(r"^module\.", "", key).replace("fc1", "linear1").replace("fc2", "linear2")
    # Lightning wraps the net as `self.model`; the recursive UNet's own top
    # Sequential is also `model`, with digit children
    if key.startswith("model.") and not re.match(r"model\.\d", key):
        key = key[len("model."):]
    return key


def reference_state_dict(model_name: str,
                         state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A state dict in the reference's naming (of `model_name`, one of the
    five models) -> the port's names, tensors as they are (norm rows
    stacked into banks)."""
    if model_name not in MODEL_NAMES:
        raise ValueError(f"no reference naming for {model_name!r}; the port reads "
                         f"{MODEL_NAMES}")
    out: dict[str, torch.Tensor] = {}
    banks: dict[tuple[str, str], dict[int, torch.Tensor]] = {}
    for key, value in state_dict.items():
        key = _strip_prefixes(key)
        if "." not in key or key.rsplit(".", 1)[1] in _DROPPED:
            continue
        value = torch.as_tensor(value)
        if m := _BANK.fullmatch(key):
            banks.setdefault((m[1], m[3]), {})[int(m[2])] = value
            continue
        module, leaf = key.rsplit(".", 1)
        out[_leaf(_module_path(module), leaf, value)] = value
    for (module, kind), rows in banks.items():
        name = ".".join([*_module_path(module), "scale" if kind == "weight" else "bias"])
        out[name] = torch.stack([rows[s] for s in sorted(rows)])
    return out


def load_reference_checkpoint(path: str | Path, model_name: str,
                              params: Mapping[str, torch.Tensor], *,
                              verbose: bool = True) -> dict[str, torch.Tensor]:
    """`params` with a reference `.pt`/`.ckpt` file merged in by
    `partial_load`'s rule: an output head of another shape stays at its
    init, the reference's own `strict=False` load (utils.py:42-63)."""
    obj = read_torch_file(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, Mapping) else obj
    return partial_load(params, reference_state_dict(model_name, sd), verbose=verbose)
