"""Evaluation metrics: Dice, symmetric surface distance, nan-aware
reductions, cross-batch buffers and the per-modality aggregation
(counterpart of `miseg_tpu/metrics.py`).

Dice runs as torch ops on the tensor's device and counts voxels in
int64, so it stays exact at any volume size (the JAX package sums in f32,
exact only up to 2^24 voxels a class; a 308 x 308 x 192 volume has
18.2 M).  The ratio is taken in f32, as there.  Surface distance runs on
the host through the C++ EDT and erosion (`utils/native.py`); the
reductions are numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .utils import native


def _finish_dice(inter: Tensor, t_o: Tensor, p_o: Tensor, ignore_empty: bool) -> Tensor:
    denom = t_o + p_o
    dice = 2.0 * inter.float() / denom.float().clamp_min(1e-38)
    if ignore_empty:
        return torch.where(t_o > 0, dice, torch.full_like(dice, float("nan")))
    return torch.where(denom > 0, dice, torch.ones_like(dice))


def dice_score(pred_onehot: Tensor, target_onehot: Tensor, *,
               include_background: bool = True, ignore_empty: bool = True) -> Tensor:
    """Dice of binarized channel-last masks `[B, *spatial, C]` -> `[B, C]`:
    NaN where the ground-truth class is absent (MONAI `ignore_empty`);
    with `ignore_empty=False` a class absent from both scores 1."""
    if not include_background:
        pred_onehot, target_onehot = pred_onehot[..., 1:], target_onehot[..., 1:]
    axes = tuple(range(1, pred_onehot.ndim - 1))
    p, t = pred_onehot != 0, target_onehot != 0
    return _finish_dice((p & t).sum(axes), t.sum(axes), p.sum(axes), ignore_empty)


def dice_score_labels(pred_labels: Tensor, target_labels: Tensor, num_classes: int, *,
                      include_background: bool = True,
                      ignore_empty: bool = True) -> Tensor:
    """`dice_score` of the one-hots of two integer label maps `[B, *spatial]`
    -> `[B, C]`, without building the one-hots: one compare and count per
    class."""
    start = 0 if include_background else 1
    axes = tuple(range(1, pred_labels.ndim))
    inter, t_c, p_c = [], [], []
    for c in range(start, num_classes):
        pe, te = pred_labels == c, target_labels == c
        inter.append((pe & te).sum(axes))
        t_c.append(te.sum(axes))
        p_c.append(pe.sum(axes))
    return _finish_dice(torch.stack(inter, -1), torch.stack(t_c, -1),
                        torch.stack(p_c, -1), ignore_empty)


def generalized_dice_score(pred_onehot: Tensor, target_onehot: Tensor, *,
                           include_background: bool = True,
                           weight_type: str = "square") -> Tensor:
    """Generalized Dice per sample -> `[B]` (MONAI GeneralizedDiceScore):
    class weights 1/(sum t_c)^2 ("square"), 1/sum t_c ("simple") or 1
    ("uniform"); a class absent from the target takes the row's largest
    weight."""
    if not include_background:
        pred_onehot, target_onehot = pred_onehot[..., 1:], target_onehot[..., 1:]
    axes = tuple(range(1, pred_onehot.ndim - 1))
    p, t = pred_onehot.float(), target_onehot.float()
    inter = (p * t).sum(axes)
    denom = p.sum(axes) + t.sum(axes)
    ground_o = t.sum(axes)
    if weight_type == "square":
        w = 1.0 / ground_o.clamp_min(1e-38).square()
    elif weight_type == "simple":
        w = 1.0 / ground_o.clamp_min(1e-38)
    else:
        w = torch.ones_like(ground_o)
    finite = ground_o > 0
    row_max = torch.where(finite, w, torch.full_like(w, -float("inf"))).amax(-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    w = torch.where(finite, w, row_max)
    numer = 2.0 * (inter * w).sum(-1)
    den = (denom * w).sum(-1)
    return torch.where(den > 0, numer / den, torch.ones_like(den))


class LossMetric:
    """Streaming scalar-loss accumulator (MONAI LossMetric)."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn
        self._vals: list[float] = []

    def __call__(self, logits, labels) -> float:
        v = float(self.loss_fn(logits, labels))
        self._vals.append(v)
        return v

    def aggregate(self, reduction: str = "mean") -> float:
        if not self._vals:
            return float("nan")
        if reduction == "mean":
            return float(np.mean(self._vals))
        if reduction == "sum":
            return float(np.sum(self._vals))
        raise ValueError(f"unknown reduction {reduction!r}")

    def reset(self) -> None:
        self._vals = []


# ------------------------------------------------------------- reductions

def reduce_mean_batch(vals) -> tuple[np.ndarray, np.ndarray]:
    """MONAI MEAN_BATCH: the nan-aware per-class batch mean of `[B, C]`
    -> (`[C]`, the count of non-NaN entries `[C]`)."""
    vals = np.asarray(vals, dtype=np.float64)
    nans = np.isnan(vals)
    not_nans = (~nans).sum(axis=0).astype(np.float64)
    summed = np.where(nans, 0.0, vals).sum(axis=0)
    out = np.where(not_nans > 0, summed / np.maximum(not_nans, 1), 0.0)
    return out, not_nans


def reduce_mean(vals) -> tuple[float, float]:
    """MONAI MEAN: each sample's nan-mean over classes, then the mean over
    the samples that had one -> (mean, their count)."""
    vals = np.asarray(vals, dtype=np.float64)
    nans = np.isnan(vals)
    not_nans = (~nans).sum(axis=1).astype(np.float64)
    per_sample = np.where(not_nans > 0,
                          np.where(nans, 0.0, vals).sum(axis=1) / np.maximum(not_nans, 1),
                          0.0)
    n_valid = float((not_nans > 0).sum())
    mean = float(per_sample.sum() / max(n_valid, 1.0)) if n_valid else 0.0
    return mean, n_valid


def nanmean_valid(per_class, not_nans) -> float:
    """Mean over the classes with at least one valid sample."""
    mask = np.asarray(not_nans) > 0
    if not mask.any():
        return float("nan")
    return float(np.nanmean(np.asarray(per_class)[mask]))


class Cumulative:
    """Cross-batch buffer of rows (MONAI `Cumulative`)."""

    def __init__(self):
        self._buffers: list[list[np.ndarray]] = []

    def extend(self, *rows) -> None:
        if not self._buffers:
            self._buffers = [[] for _ in rows]
        for buf, r in zip(self._buffers, rows):
            buf.append(np.asarray(r))

    def get_buffer(self):
        out = tuple(np.concatenate(b, axis=0) for b in self._buffers)
        return out if len(out) > 1 else out[0]

    def reset(self) -> None:
        self._buffers = []


class MetricAccumulator:
    """Streaming `[B, C]` metric rows, aggregated nan-aware (MONAI's
    `DiceMetric` aggregate/reset cycle)."""

    def __init__(self, include_background: bool = True):
        self.include_background = include_background
        self._rows: list[np.ndarray] = []

    def __call__(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        self._rows.append(rows)
        return rows

    def aggregate(self, reduction: str = "mean_batch"):
        vals = np.concatenate(self._rows, axis=0)
        if reduction == "mean_batch":
            return reduce_mean_batch(vals)
        if reduction == "mean":
            return reduce_mean(vals)
        raise ValueError(f"unknown reduction {reduction!r}")

    def reset(self) -> None:
        self._rows = []


def metric_by_modality(vals, modalities, label: str = "dice", class_offset: int = 0,
                       ns: str = "val") -> dict[str, float]:
    """For each modality m: the nan-aware per-class batch mean and the mean
    of the classes that had a valid sample, as
    `{ns}_modality{m}_{label}/class{c}` and `{ns}_modality{m}_{label}/avg`."""
    vals = np.asarray(vals, dtype=np.float64)
    modalities = np.asarray(modalities).reshape(-1)
    out: dict[str, float] = {}
    for m in np.unique(modalities):
        per_class, not_nans = reduce_mean_batch(vals[modalities == m])
        for c, x in enumerate(per_class.tolist()):
            out[f"{ns}_modality{int(m)}_{label}/class{c + class_offset}"] = x
        out[f"{ns}_modality{int(m)}_{label}/avg"] = nanmean_valid(per_class, not_nans)
    return out


# ------------------------------------------------------- surface distance

def _mask_edges(mask: np.ndarray) -> np.ndarray:
    """Surface voxels: the mask XOR its erosion."""
    if not mask.any():
        return np.zeros_like(mask, dtype=bool)
    return mask ^ native.binary_erosion(mask)


def _surface_distances(src_edges: np.ndarray, dst_edges: np.ndarray) -> np.ndarray:
    """Distance of each surface voxel of `src` to the surface of `dst`."""
    if not dst_edges.any():
        return np.full(int(src_edges.sum()), np.inf)
    return np.asarray(native.edt(dst_edges)[src_edges], dtype=np.float64)


def surface_distance(pred_onehot, target_onehot, *, include_background: bool = True,
                     symmetric: bool = True) -> np.ndarray:
    """Average (symmetric) surface distance in voxels of channel-last
    one-hots `[B, *spatial, C]` -> `[B, C]`, on the host; NaN where neither
    mask has a surface (MONAI's conventions)."""
    pred = np.asarray(pred_onehot).astype(bool)
    target = np.asarray(target_onehot).astype(bool)
    if not include_background:
        pred, target = pred[..., 1:], target[..., 1:]
    b, c = pred.shape[0], pred.shape[-1]
    out = np.full((b, c), np.nan)
    for i in range(b):
        for j in range(c):
            ep = _mask_edges(pred[i, ..., j])
            eg = _mask_edges(target[i, ..., j])
            d = _surface_distances(ep, eg)
            if symmetric:
                d = np.concatenate([d, _surface_distances(eg, ep)])
            out[i, j] = d.mean() if d.size else np.nan
    return out
