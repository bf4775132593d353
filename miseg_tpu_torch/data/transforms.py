"""Dict-based, invertible preprocessing transforms (host numpy): the
deterministic half of `miseg_tpu/data/transforms.py`.

LoadImaged, EnsureChannelLastd (volumes are channel-last `[X, Y, Z, C]`),
Orientationd (RAS), Spacingd (affine-aware resample, bilinear/nearest,
through the port's C++ resampler `utils/native.py`), ScaleIntensityd,
SpatialPadd and ToTensord, and `Compose` with the op record (`_push_op`)
that `Compose.inverse` replays backwards to bring a prediction back to
the scan's own voxel grid.  Every array a transform returns has
non-negative strides (`np.flip` results are copied), so it can reach
`torch.from_numpy`.

The random training tail (FgBgToIndicesd, RandCropByPosNegLabeld,
RandFlipd, RandRotate90d, RandScaleIntensityd, RandShiftIntensityd) draws
from the `numpy.random.Generator` in `data["_rng"]` (the loader seeds one
per item and epoch) the same numbers in the same order as the JAX
package's, so one generator gives the same crops, bit for bit.  A
transform that emits several crops makes `Compose` return a list of
dicts, one a crop.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..utils import native
from .nifti import load_nifti

DataDict = dict


def _keys(self, data):
    for k in self.keys:
        if k in data:
            yield k
        elif not self.allow_missing_keys:
            raise KeyError(f"{type(self).__name__}: missing key {k!r}")


def _push_op(data: DataDict, key: str, name: str, info: dict) -> None:
    data.setdefault("_ops", {}).setdefault(key, []).append({"name": name, **info})


class Transform:
    """Base dict transform. Subclasses set `keys` and override __call__."""

    def __init__(self, keys, allow_missing_keys: bool = False):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.allow_missing_keys = allow_missing_keys

    def inverse_op(self, arr: np.ndarray, op: dict) -> np.ndarray:
        raise NotImplementedError(f"{type(self).__name__} is not invertible")


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, data: DataDict) -> DataDict | list[DataDict]:
        out = [dict(data)]
        for t in self.transforms:
            nxt = []
            for d in out:
                r = t(d)
                nxt.extend(r if isinstance(r, list) else [r])
            out = nxt
        return out if len(out) > 1 else out[0]

    def inverse(self, data: DataDict, key: str = "label") -> DataDict:
        """Undo recorded spatial ops for `key` (MONAI Compose.inverse)."""
        data = dict(data)
        arr = np.asarray(data[key])
        ops = list(data.get("_ops", {}).get(key, []))
        by_name = {type(t).__name__: t for t in self.transforms}
        for op in reversed(ops):
            t = by_name.get(op["name"])
            if t is None:
                raise KeyError(f"no transform named {op['name']} to invert")
            arr = t.inverse_op(arr, op)
        data[key] = arr
        return data


# ------------------------------------------------------------------ I/O

class LoadImaged(Transform):
    def __call__(self, data):
        data = dict(data)
        for k in _keys(self, data):
            src = data[k]
            if isinstance(src, (str, Path)):
                img = load_nifti(src)
                data[k] = img.data.astype(np.float32)
                data[f"{k}_meta"] = {
                    "affine": img.affine.copy(),
                    "original_affine": img.affine.copy(),
                    "spatial_shape": tuple(img.data.shape),
                    "filename_or_obj": str(src),
                }
        return data


class EnsureChannelLastd(Transform):
    """Append a trailing channel axis (TPU-layout analog of
    EnsureChannelFirstd — data/multi_modal.py:39)."""

    def __call__(self, data):
        data = dict(data)
        for k in _keys(self, data):
            arr = np.asarray(data[k])
            if arr.ndim == 3:
                data[k] = arr[..., None]
                _push_op(data, k, "EnsureChannelLastd", {})
        return data

    def inverse_op(self, arr, op):
        return arr[..., 0] if arr.ndim == 4 and arr.shape[-1] == 1 else arr


# ----------------------------------------------------------- orientation

_AXCODE_SIGN = {"R": ("R", "L"), "A": ("A", "P"), "S": ("S", "I")}


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """[nd, 2] (input axis, sign) rows per output RAS axis (nibabel algo)."""
    R = np.asarray(affine)[:3, :3]
    # normalize columns; pick dominant world axis per voxel axis greedily
    Q = R / np.maximum(np.linalg.norm(R, axis=0, keepdims=True), 1e-12)
    out = np.zeros((3, 2))
    used_world = set()
    order = np.argsort(-np.abs(Q).max(axis=0))  # voxel axes by decisiveness
    for vox in order:
        col = np.abs(Q[:, vox]).copy()
        for w in used_world:
            col[w] = -1
        world = int(np.argmax(col))
        used_world.add(world)
        out[vox] = (world, np.sign(Q[world, vox]) or 1.0)
    return out


class Orientationd(Transform):
    """Reorient voxels so the affine is axis-aligned with `axcodes` (RAS)."""

    def __init__(self, keys, axcodes: str = "RAS", allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        if axcodes != "RAS":
            raise NotImplementedError("only RAS axcodes supported (reference uses RAS)")

    def __call__(self, data):
        data = dict(data)
        meta_key = f"{self.keys[0]}_meta"
        affine = None
        for k in _keys(self, data):
            m = data.get(f"{k}_meta") or data.get(meta_key)
            affine = m["affine"] if m else np.eye(4)
            ornt = io_orientation(affine)  # per voxel axis: (world axis, sign)
            perm = [int(np.where(ornt[:, 0] == w)[0][0]) for w in range(3)]
            flips = [v for v in perm if ornt[v, 1] < 0]  # input-axis indices

            arr = np.asarray(data[k])
            has_c = arr.ndim == 4
            spatial = arr.shape[:3]
            if flips:
                arr = np.flip(arr, axis=flips)
            axes = perm + ([3] if has_c else [])
            arr = np.transpose(arr, axes)
            data[k] = np.ascontiguousarray(arr)
            _push_op(data, k, "Orientationd",
                     {"perm": perm, "flips": flips, "shape": spatial})
            if f"{k}_meta" in data:
                new_aff = _reoriented_affine(affine, perm, flips, spatial)
                data[f"{k}_meta"] = {**data[f"{k}_meta"], "affine": new_aff}
        return data

    def inverse_op(self, arr, op):
        perm, flips = op["perm"], op["flips"]
        has_c = arr.ndim == 4
        inv_perm = list(np.argsort(perm)) + ([3] if has_c else [])
        arr = np.transpose(arr, inv_perm)
        if flips:
            arr = np.flip(arr, axis=flips)
        return np.ascontiguousarray(arr)


def _reoriented_affine(affine, perm, flips, spatial):
    """Affine after flipping `flips` axes then permuting axes by `perm`."""
    aff = np.asarray(affine, dtype=np.float64).copy()
    F = np.eye(4)
    for ax in flips:
        F[ax, ax] = -1.0
        F[ax, 3] = spatial[ax] - 1
    P = np.zeros((4, 4))
    for out_ax, in_ax in enumerate(perm):
        P[in_ax, out_ax] = 1.0
    P[3, 3] = 1.0
    return aff @ F @ P


# -------------------------------------------------------------- spacing

class Spacingd(Transform):
    def __init__(self, keys, pixdim, mode=("bilinear", "nearest"),
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.pixdim = np.asarray(pixdim, dtype=np.float64)
        self.mode = [mode] * len(self.keys) if isinstance(mode, str) else list(mode)

    @staticmethod
    def _resample(arr, matrix, out_shape, order):
        has_c = arr.ndim == 4
        chans = []
        for c in range(arr.shape[-1] if has_c else 1):
            vol = np.ascontiguousarray(arr[..., c] if has_c else arr,
                                       dtype=np.float32)
            res = native.resample_affine(vol, matrix[:3, :3], matrix[:3, 3],
                                         tuple(out_shape), order)
            chans.append(res)
        out = np.stack(chans, axis=-1) if has_c else chans[0]
        return out.astype(np.float32)

    def __call__(self, data):
        data = dict(data)
        for k, mode in zip(self.keys, self.mode):
            if k not in data:
                if self.allow_missing_keys:
                    continue
                raise KeyError(k)
            meta = data.get(f"{k}_meta") or data.get(f"{self.keys[0]}_meta")
            affine = meta["affine"] if meta else np.eye(4)
            arr = np.asarray(data[k])
            spatial = arr.shape[:3]
            old_spacing = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)
            new_affine = np.asarray(affine, dtype=np.float64).copy()
            new_affine[:3, :3] = new_affine[:3, :3] / old_spacing * self.pixdim
            out_shape = np.maximum(
                1, np.ceil(np.asarray(spatial) * old_spacing / self.pixdim - 1e-4)
            ).astype(int)
            # output voxel → input voxel map
            matrix = np.linalg.inv(np.asarray(affine)) @ new_affine
            order = 1 if mode == "bilinear" else 0
            data[k] = self._resample(arr, matrix, out_shape, order)
            _push_op(data, k, "Spacingd",
                     {"matrix_inv": (np.linalg.inv(matrix)).tolist(),
                      "orig_shape": tuple(spatial), "order": order})
            if meta is not None and f"{k}_meta" in data:
                data[f"{k}_meta"] = {**meta, "affine": new_affine}
        return data

    def inverse_op(self, arr, op):
        matrix = np.asarray(op["matrix_inv"], dtype=np.float64)
        # discrete data inverts with nearest to preserve label ids
        return self._resample(np.asarray(arr, np.float32), matrix,
                              op["orig_shape"], 0 if op["order"] == 0 else 1)


# ------------------------------------------------------------- intensity

class ScaleIntensityd(Transform):
    """Min-max scale to [0, 1] (MONAI ScaleIntensity defaults)."""

    def __call__(self, data):
        data = dict(data)
        for k in _keys(self, data):
            arr = np.asarray(data[k], dtype=np.float32)
            mn, mx = float(arr.min()), float(arr.max())
            if mx > mn:
                arr = (arr - mn) / (mx - mn)
            else:
                arr = arr - mn
            data[k] = arr
        return data


class RandScaleIntensityd(Transform):
    def __init__(self, keys, factors: float, prob: float,
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.factors = factors
        self.prob = prob

    def __call__(self, data):
        data = dict(data)
        rng: np.random.Generator = data["_rng"]
        if rng.random() < self.prob:
            factor = rng.uniform(-self.factors, self.factors)
            for k in _keys(self, data):
                data[k] = np.asarray(data[k], np.float32) * (1.0 + factor)
        return data


class RandShiftIntensityd(Transform):
    def __init__(self, keys, offsets: float, prob: float,
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.offsets = offsets
        self.prob = prob

    def __call__(self, data):
        data = dict(data)
        rng: np.random.Generator = data["_rng"]
        if rng.random() < self.prob:
            offset = rng.uniform(-self.offsets, self.offsets)
            for k in _keys(self, data):
                data[k] = np.asarray(data[k], np.float32) + offset
        return data


# ---------------------------------------------------------------- spatial


# ---------------------------------------------------------------- spatial

class SpatialPadd(Transform):
    """Pad spatial dims up to `spatial_size` (symmetric, constant value)."""

    def __init__(self, keys, spatial_size, value: float = 0.0,
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.spatial_size = tuple(spatial_size)
        self.value = value

    def __call__(self, data):
        data = dict(data)
        for k in _keys(self, data):
            arr = np.asarray(data[k])
            spatial = arr.shape[:3]
            pads = []
            for s, t in zip(spatial, self.spatial_size):
                extra = max(0, t - s)
                pads.append((extra // 2, extra - extra // 2))
            if any(p != (0, 0) for p in pads):
                full = pads + [(0, 0)] * (arr.ndim - 3)
                arr = np.pad(arr, full, constant_values=self.value)
            data[k] = arr
            _push_op(data, k, "SpatialPadd", {"pads": pads, "shape": spatial})
        return data

    def inverse_op(self, arr, op):
        sl = tuple(slice(p[0], p[0] + s) for p, s in zip(op["pads"], op["shape"]))
        return arr[sl + (Ellipsis,)]


class FgBgToIndicesd(Transform):
    """Precompute foreground/background flat voxel indices for
    `RandCropByPosNegLabeld` (MONAI FgBgToIndicesd).

    Deterministic, so `CacheDataset` caches it in the prefix — the
    per-epoch full-volume argwhere the crop would otherwise redo on every
    sample draw happens exactly once per cached item.
    """

    def __init__(self, keys="label", image_key: str | None = None,
                 image_threshold: float = 0.0, allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.image_key = image_key
        self.image_threshold = image_threshold

    def __call__(self, data):
        data = dict(data)
        for k in _keys(self, data):
            label = np.asarray(data[k])
            lab3 = label[..., 0] if label.ndim == 4 else label
            fg_mask = lab3 > 0
            if self.image_key and self.image_key in data:
                img = np.asarray(data[self.image_key])
                img3 = img[..., 0] if img.ndim == 4 else img
                bg_mask = (~fg_mask) & (img3 > self.image_threshold)
            else:
                bg_mask = ~fg_mask
            data[f"{k}_fg_indices"] = np.flatnonzero(fg_mask)
            data[f"{k}_bg_indices"] = np.flatnonzero(bg_mask)
        return data


class RandCropByPosNegLabeld(Transform):
    """Class-balanced ROI sampling (MONAI RandCropByPosNegLabeld).

    Draws `num_samples` crops; each center comes from the label foreground
    with prob pos/(pos+neg), else from background voxels where
    image > image_threshold.  Centers are clamped so crops stay in-bounds.

    When `{label_key}_fg_indices`/`_bg_indices` are present (precomputed by
    `FgBgToIndicesd` in the deterministic/cached prefix), centers are drawn
    from those flat indices with no per-draw argwhere.
    """

    def __init__(self, keys, label_key: str, spatial_size, pos: float = 1.0,
                 neg: float = 1.0, num_samples: int = 1,
                 image_key: str | None = None, image_threshold: float = 0.0,
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.label_key = label_key
        self.spatial_size = tuple(spatial_size)
        self.pos_ratio = pos / (pos + neg)
        self.num_samples = num_samples
        self.image_key = image_key
        self.image_threshold = image_threshold

    def _pools(self, data, spatial):
        fg_flat = data.get(f"{self.label_key}_fg_indices")
        bg_flat = data.get(f"{self.label_key}_bg_indices")
        if fg_flat is not None and bg_flat is not None:
            return np.asarray(fg_flat), np.asarray(bg_flat)
        label = np.asarray(data[self.label_key])
        lab3 = label[..., 0] if label.ndim == 4 else label
        fg_mask = lab3 > 0
        if self.image_key and self.image_key in data:
            img = np.asarray(data[self.image_key])
            img3 = img[..., 0] if img.ndim == 4 else img
            bg_mask = (~fg_mask) & (img3 > self.image_threshold)
        else:
            bg_mask = ~fg_mask
        return np.flatnonzero(fg_mask), np.flatnonzero(bg_mask)

    def __call__(self, data):
        rng: np.random.Generator = data["_rng"]
        label = np.asarray(data[self.label_key])
        spatial = label.shape[:3] if label.ndim == 4 else label.shape
        fg, bg = self._pools(data, spatial)

        out = []
        for _ in range(self.num_samples):
            use_fg = (rng.random() < self.pos_ratio and len(fg) > 0) or len(bg) == 0
            pool = fg if use_fg else bg
            if len(pool) == 0:
                center = [s // 2 for s in spatial]
            else:
                center = np.unravel_index(int(pool[rng.integers(len(pool))]),
                                          spatial)
            starts = [int(np.clip(c - r // 2, 0, max(0, s - r)))
                      for c, r, s in zip(center, self.spatial_size, spatial)]
            sl = tuple(slice(st, st + r) for st, r in zip(starts, self.spatial_size))
            d = dict(data)
            # index pools describe the full volume — stale after the crop
            d.pop(f"{self.label_key}_fg_indices", None)
            d.pop(f"{self.label_key}_bg_indices", None)
            for k in _keys(self, data):
                d[k] = np.ascontiguousarray(np.asarray(data[k])[sl + (Ellipsis,)])
            out.append(d)
        return out


class RandFlipd(Transform):
    def __init__(self, keys, prob: float, spatial_axis: int,
                 allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.spatial_axis = spatial_axis

    def __call__(self, data):
        data = dict(data)
        rng: np.random.Generator = data["_rng"]
        if rng.random() < self.prob:
            for k in _keys(self, data):
                data[k] = np.ascontiguousarray(
                    np.flip(np.asarray(data[k]), axis=self.spatial_axis))
        return data


class RandRotate90d(Transform):
    def __init__(self, keys, prob: float, max_k: int = 3,
                 spatial_axes=(0, 1), allow_missing_keys=False):
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.max_k = max_k
        self.spatial_axes = tuple(spatial_axes)

    def __call__(self, data):
        data = dict(data)
        rng: np.random.Generator = data["_rng"]
        if rng.random() < self.prob:
            k = int(rng.integers(self.max_k)) + 1
            for key in _keys(self, data):
                data[key] = np.ascontiguousarray(
                    np.rot90(np.asarray(data[key]), k, axes=self.spatial_axes))
        return data


class ToTensord(Transform):
    """No-op: arrays stay numpy on the host; the caller moves the image to
    the device."""

    def __call__(self, data):
        return dict(data)
