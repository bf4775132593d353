"""Dict-based, invertible preprocessing transforms (host numpy): the
deterministic half of `miseg_tpu/data/transforms.py`.

LoadImaged, EnsureChannelLastd (volumes are channel-last `[X, Y, Z, C]`),
Orientationd (RAS), Spacingd (affine-aware resample, bilinear/nearest,
through the port's C++ resampler `utils/native.py`), ScaleIntensityd,
SpatialPadd and ToTensord, and `Compose` with the op record (`_push_op`)
that `Compose.inverse` replays backwards to bring a prediction back to
the scan's own voxel grid.  Every array a transform returns has
non-negative strides (`np.flip` results are copied), so it can reach
`torch.from_numpy`.  The random training transforms are not ported yet.
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

    def __call__(self, data: DataDict) -> DataDict:
        data = dict(data)
        for t in self.transforms:
            data = t(data)
        return data

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


class ToTensord(Transform):
    """No-op: arrays stay numpy on the host; the caller moves the image to
    the device."""

    def __call__(self, data):
        return dict(data)
