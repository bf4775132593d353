"""The port's losses (`miseg_tpu_torch.losses`) against the JAX package's
`miseg_tpu/losses.py` on the same logits and labels (CPU, f32): the value
and the gradient with respect to the logits (`jax.grad`), atol 1e-6.

The labels leave class 3 out of the second sample, so the generalized
dice takes its weight fallback (an empty class's weight -> the largest
finite weight of its sample)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, t

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu_torch import losses as TL
from miseg_tpu_torch.config import Config

torch.set_num_threads(1)
ATOL = 1e-6
SHAPE = (2, 8, 8, 8, 4)

_LOSSES = {
    "dice": dict(squared_pred=True, smooth_nr=0.0, smooth_dr=1e-6),
    "dice_linear": dict(squared_pred=False, smooth_nr=1e-5, smooth_dr=1e-5),
    "dice_no_background": dict(include_background=False),
    "focal": dict(),
    "focal_no_background": dict(include_background=False),
    "cross_entropy": dict(),
    "generalized_dice": dict(),
    "dice_focal": dict(),
    "dice_ce": dict(),
    "generalized_dice_focal": dict(),
}


def _fns(name):
    base = name.replace("_linear", "").replace("_no_background", "")
    return getattr(JL, f"{base}_loss"), getattr(TL, f"{base}_loss")


@pytest.fixture
def batch(rng):
    logits = (2.0 * rng.standard_normal(SHAPE)).astype(np.float32)
    labels = rng.integers(0, 4, SHAPE[:-1]).astype(np.int32)
    labels[1][labels[1] == 3] = 2          # class 3 absent from sample 1
    return logits, labels


def _compare(jfn, tfn, logits, labels, label_shape=None):
    lab = labels if label_shape is None else labels.reshape(label_shape)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(lab))
    x = t(logits).requires_grad_(True)
    got = tfn(x, t(lab))
    (got_g,) = torch.autograd.grad(got, x)
    return max_err(got, want), max_err(got_g, want_g)


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_matches_jax(batch, name):
    jfn, tfn = _fns(name)
    kw = _LOSSES[name]
    err, gerr = _compare(lambda a, b: jfn(a, b, **kw), lambda a, b: tfn(a, b, **kw), *batch)
    print(f"{name}: |loss diff| {err:.2e}, max |grad diff| {gerr:.2e}")
    assert err <= ATOL and gerr <= ATOL


@pytest.mark.parametrize("criterion,squared", [("dice_focal", False), ("dice_ce", False),
                                               ("dice_ce", True),
                                               ("generalized_dice_focal", False)])
def test_loss_from_config_matches_jax(batch, criterion, squared):
    """Labels as `[B, *spatial, 1]`, as a data loader gives them."""
    kw = dict(criterion=criterion, squared_dice=squared, smooth_nr=1e-5, smooth_dr=1e-5)
    logits, labels = batch
    err, gerr = _compare(JL.loss_from_config(JConfig(**kw)), TL.loss_from_config(Config(**kw)),
                         logits, labels, (*labels.shape, 1))
    assert err <= ATOL and gerr <= ATOL


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="not implemented"):
        TL.loss_from_config(Config(criterion="hinge"))
