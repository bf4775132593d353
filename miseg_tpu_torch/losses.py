"""Segmentation losses: Dice, DiceCE, DiceFocal, GeneralizedDiceFocal
(counterpart of `miseg_tpu/losses.py`, MONAI 1.1.0 semantics).

Logits are channel-last `[B, *spatial, C]`, labels integer `[B, *spatial]`
(or `[B, *spatial, 1]`); the math is f32.  As in the JAX package the
one-hot target is never built as floats: every reduction compares the
labels with the class ids inline, and `sum(target^2) = sum(target)` is the
per-class voxel count.  Focal is the BCE-with-logits focal on the raw
per-class logits in its signed-logit form: with t in {0, 1} and
`s = where(t, x, -x)`, BCE = softplus(-s) and p = sigmoid(s).

Under spatial partitioning (`parallel/spatial.py`) the logits and labels
are a D slab of the patch: the per-(sample, class) sums of the dice
losses are summed over the line (`spatial.line_sum`, an all-reduce whose
backward is the identity) and the focal and cross-entropy means are the
line's summed sum over the whole patch's voxels (`spatial.line_mean`), so
every rank's loss is the whole patch's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .parallel import spatial

Tensor = torch.Tensor


def _int_labels(labels: Tensor) -> Tensor:
    """Accept `[B, *spatial]` or `[B, *spatial, 1]` integer labels."""
    if labels.ndim >= 2 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return labels.long()


def _layout(logits: Tensor, labels: Tensor, start: int):
    """`(x_f32, eq_bool, spatial_dims)` in the channel-last layout
    (losses.py:95): x keeps all classes, `eq` covers classes `start..C`."""
    x = logits.float()
    classes = torch.arange(start, x.shape[-1], device=x.device)
    eq = _int_labels(labels)[..., None] == classes
    return x, eq, tuple(range(1, x.ndim - 1))


def dice_loss(logits: Tensor, labels: Tensor, *, include_background: bool = True,
              squared_pred: bool = True, smooth_nr: float = 0.0,
              smooth_dr: float = 1e-6, softmax: bool = True) -> Tensor:
    start = 0 if include_background else 1
    x, eq, saxes = _layout(logits, labels, start)
    probs = (torch.softmax(x, dim=-1) if softmax else x)[..., start:]
    intersection = spatial.line_sum(torch.where(eq, probs, 0.0).sum(saxes), x)   # [B, C]
    tsum = spatial.line_sum(eq.sum(saxes, dtype=torch.float32), x)
    denom = spatial.line_sum((probs.square() if squared_pred else probs).sum(saxes), x) + tsum
    return (1.0 - (2.0 * intersection + smooth_nr) / (denom + smooth_dr)).mean()


def focal_loss(logits: Tensor, labels: Tensor, *, include_background: bool = True,
               gamma: float = 2.0) -> Tensor:
    start = 0 if include_background else 1
    x, eq, _ = _layout(logits, labels, start)
    x = x[..., start:]
    s = torch.where(eq, x, -x)
    return spatial.line_mean(torch.pow(1.0 - torch.sigmoid(s), gamma) * F.softplus(-s), x)


def cross_entropy_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Softmax cross-entropy on integer labels (torch CrossEntropyLoss mean)."""
    x, eq, _ = _layout(logits, labels, 0)
    x_at_label = torch.where(eq, x, 0.0).sum(-1)
    return spatial.line_mean(torch.logsumexp(x, dim=-1) - x_at_label, x)


def generalized_dice_loss(logits: Tensor, labels: Tensor, *,
                          include_background: bool = True,
                          smooth_nr: float = 0.0, smooth_dr: float = 1e-6,
                          softmax: bool = True) -> Tensor:
    start = 0 if include_background else 1
    x, eq, saxes = _layout(logits, labels, start)
    probs = (torch.softmax(x, dim=-1) if softmax else x)[..., start:]
    intersection = spatial.line_sum(torch.where(eq, probs, 0.0).sum(saxes), x)   # [B, C]
    ground_o = spatial.line_sum(eq.sum(saxes, dtype=torch.float32), x)
    denominator = spatial.line_sum(probs.sum(saxes), x) + ground_o
    w = 1.0 / torch.square(ground_o.clamp_min(0.0) + 1e-38)
    # an empty class's infinite weight -> the largest finite weight of its sample
    finite = ground_o > 0
    row_max = torch.where(finite, w, -torch.inf).amax(-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    w = torch.where(finite, w, row_max)
    numer = 2.0 * (intersection * w).sum(-1) + smooth_nr             # per sample
    denom = (denominator * w).sum(-1) + smooth_dr
    return (1.0 - numer / denom).mean()


def dice_focal_loss(logits, labels, *, include_background=True, squared_pred=True,
                    smooth_nr=0.0, smooth_dr=1e-6, gamma=2.0,
                    lambda_dice=1.0, lambda_focal=1.0):
    return (lambda_dice * dice_loss(logits, labels,
                                    include_background=include_background,
                                    squared_pred=squared_pred,
                                    smooth_nr=smooth_nr, smooth_dr=smooth_dr)
            + lambda_focal * focal_loss(logits, labels,
                                        include_background=include_background,
                                        gamma=gamma))


def dice_ce_loss(logits, labels, *, include_background=True, squared_pred=False,
                 smooth_nr=0.0, smooth_dr=1e-6, lambda_dice=1.0, lambda_ce=1.0):
    return (lambda_dice * dice_loss(logits, labels,
                                    include_background=include_background,
                                    squared_pred=squared_pred,
                                    smooth_nr=smooth_nr, smooth_dr=smooth_dr)
            + lambda_ce * cross_entropy_loss(logits, labels))


def generalized_dice_focal_loss(logits, labels, *, include_background=True,
                                smooth_nr=0.0, smooth_dr=1e-6, gamma=2.0,
                                lambda_gdl=1.0, lambda_focal=1.0):
    return (lambda_gdl * generalized_dice_loss(logits, labels,
                                               include_background=include_background,
                                               smooth_nr=smooth_nr,
                                               smooth_dr=smooth_dr)
            + lambda_focal * focal_loss(logits, labels,
                                        include_background=include_background,
                                        gamma=gamma))


def loss_from_config(cfg) -> Callable[[Tensor, Tensor], Tensor]:
    """Config -> loss callable (losses.py:225).  Background is always
    included, as in the reference (training_utils.py:8-10)."""
    name = cfg.criterion
    if name == "dice_focal":
        return lambda lg, lb: dice_focal_loss(lg, lb, squared_pred=True,
                                              smooth_nr=cfg.smooth_nr,
                                              smooth_dr=cfg.smooth_dr)
    if name == "dice_ce":
        return lambda lg, lb: dice_ce_loss(lg, lb, squared_pred=cfg.squared_dice,
                                           smooth_nr=cfg.smooth_nr,
                                           smooth_dr=cfg.smooth_dr)
    if name == "generalized_dice_focal":
        return lambda lg, lb: generalized_dice_focal_loss(lg, lb,
                                                          smooth_nr=cfg.smooth_nr,
                                                          smooth_dr=cfg.smooth_dr)
    raise ValueError(f"criterion {name!r} is not implemented")
