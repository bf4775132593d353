"""The port's metrics (`miseg_tpu_torch/metrics.py`) against the JAX
package's (`miseg_tpu/metrics.py`), on the CPU.

* Dice in both forms and the generalized Dice within 1e-6 of JAX's on
  seeded masks and label maps; the port counts voxels in int64, so its
  Dice stays exact past 2^24 voxels a class.
* The reductions, buffers and `metric_by_modality` equal to JAX's (keys
  identical, values within 1e-12: both are float64 numpy).
* Surface distance within 1e-5 of JAX's: both run the same C++ source
  (`native/miseg_native.cpp`), and the port's EDT and erosion bindings
  match scipy's `distance_transform_edt` (1e-5) and `binary_erosion`
  (exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from miseg_tpu import metrics as JM
from miseg_tpu_torch import metrics as M
from miseg_tpu_torch.utils import native

torch.set_num_threads(1)
ATOL_DICE = 1e-6
ATOL_SURFACE = 1e-5


def _labels(rng, shape, classes, absent=()):
    lab = rng.integers(0, classes, shape)
    for c in absent:
        lab[lab == c] = 0
    return lab


def _onehot(lab, classes):
    return (lab[..., None] == np.arange(classes)).astype(np.float32)


@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("ignore_empty", [True, False])
def test_dice_score_matches_jax(rng, include_background, ignore_empty):
    pred = _labels(rng, (3, 9, 8, 7), 5, absent=(2,))
    target = _labels(rng, (3, 9, 8, 7), 5, absent=(3,))
    kw = dict(include_background=include_background, ignore_empty=ignore_empty)
    want = np.asarray(JM.dice_score(jnp.asarray(_onehot(pred, 5)),
                                    jnp.asarray(_onehot(target, 5)), **kw))
    got = M.dice_score(torch.from_numpy(_onehot(pred, 5)),
                       torch.from_numpy(_onehot(target, 5)), **kw).numpy()
    assert got.shape == want.shape == (3, 5 if include_background else 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL_DICE, equal_nan=True)
    labels = M.dice_score_labels(torch.from_numpy(pred), torch.from_numpy(target), 5, **kw)
    want_labels = np.asarray(JM.dice_score_labels(jnp.asarray(pred), jnp.asarray(target), 5,
                                                  **kw))
    np.testing.assert_allclose(labels.numpy(), want_labels, atol=ATOL_DICE, equal_nan=True)
    np.testing.assert_allclose(labels.numpy(), got, atol=ATOL_DICE, equal_nan=True)


def test_dice_counts_exactly_past_2_24_voxels():
    """18.2 M voxels (a 308 x 308 x 192 volume), one class nearly everywhere:
    the port's int64 counts give the f32 ratio of the exact counts."""
    target = np.ones((1, 308, 308, 192), np.uint8)
    pred = target.copy()
    pred[0, :3] = 0                    # 283,776 voxels predicted background
    got = M.dice_score_labels(torch.from_numpy(pred), torch.from_numpy(target), 2)[0, 1]
    n = target.size
    inter, p_o = n - 3 * 308 * 192, n - 3 * 308 * 192
    assert n > 2 ** 24
    assert float(got) == float(np.float32(2.0 * np.float32(inter)) / np.float32(n + p_o))


@pytest.mark.parametrize("weight_type", ["square", "simple", "uniform"])
@pytest.mark.parametrize("include_background", [True, False])
def test_generalized_dice_matches_jax(rng, weight_type, include_background):
    pred = _onehot(_labels(rng, (2, 7, 6, 5), 4), 4)
    target = _onehot(_labels(rng, (2, 7, 6, 5), 4, absent=(2,)), 4)
    kw = dict(include_background=include_background, weight_type=weight_type)
    want = np.asarray(JM.generalized_dice_score(jnp.asarray(pred), jnp.asarray(target), **kw))
    got = M.generalized_dice_score(torch.from_numpy(pred), torch.from_numpy(target), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ATOL_DICE)


def test_reductions_and_buffers_match_jax(rng):
    vals = rng.random((6, 4))
    vals[rng.random((6, 4)) < 0.3] = np.nan
    vals[:, 2] = np.nan                     # a class no sample has
    for got, want in zip(M.reduce_mean_batch(vals), JM.reduce_mean_batch(vals)):
        np.testing.assert_array_equal(got, want)
    assert M.reduce_mean(vals) == JM.reduce_mean(vals)
    pc, nn_ = M.reduce_mean_batch(vals)
    assert M.nanmean_valid(pc, nn_) == JM.nanmean_valid(pc, nn_)
    assert np.isnan(M.nanmean_valid(pc, np.zeros_like(nn_)))

    cum, jcum = M.Cumulative(), JM.Cumulative()
    acc, jacc = M.MetricAccumulator(), JM.MetricAccumulator()
    for i in range(3):
        rows, mods = vals[2 * i:2 * i + 2], np.array([i % 2, 1])
        cum.extend(rows, mods)
        jcum.extend(rows, mods)
        acc(rows)
        jacc(rows)
    for got, want in zip(cum.get_buffer(), jcum.get_buffer()):
        np.testing.assert_array_equal(got, want)
    for red in ("mean_batch", "mean"):
        got, want = acc.aggregate(red), jacc.aggregate(red)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def loss(a, b):
        return float(np.mean((a - b) ** 2))

    lm, jlm = M.LossMetric(loss), JM.LossMetric(loss)
    for i in range(4):
        a, b = rng.random(3), rng.random(3)
        assert lm(a, b) == jlm(a, b)
    for red in ("mean", "sum"):
        assert lm.aggregate(red) == jlm.aggregate(red)
    lm.reset()
    assert np.isnan(lm.aggregate())


@pytest.mark.parametrize("offset", [0, 1])
def test_metric_by_modality_matches_jax(rng, offset):
    vals = rng.random((7, 3))
    vals[rng.random((7, 3)) < 0.25] = np.nan
    mods = np.array([0, 1, 1, 0, 1, 0, 0])
    got = M.metric_by_modality(vals, mods, "surface_distance", offset, ns="test")
    want = JM.metric_by_modality(vals, mods, "surface_distance", offset, ns="test")
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], atol=1e-12,
                               equal_nan=True)


def _blobs(rng, shape, classes):
    """Label maps of overlapping balls, so each class has a surface."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    lab = np.zeros(shape, np.int64)
    for c in range(1, classes):
        centre = rng.uniform(0.25, 0.75, 3) * np.asarray(shape)
        r = rng.uniform(0.15, 0.3) * min(shape)
        lab[((grid - centre) ** 2).sum(-1) < r * r] = c
    return lab


@pytest.mark.parametrize("include_background", [True, False])
def test_surface_distance_matches_jax(rng, include_background):
    shape = (18, 16, 14)
    pred = np.stack([_blobs(rng, shape, 4) for _ in range(2)])
    target = np.stack([_blobs(rng, shape, 4) for _ in range(2)])
    target[1][target[1] == 2] = 0          # a class with no ground-truth surface
    kw = dict(include_background=include_background)
    got = M.surface_distance(_onehot(pred, 4), _onehot(target, 4), **kw)
    want = JM.surface_distance(_onehot(pred, 4), _onehot(target, 4), **kw)
    assert got.shape == want.shape == (2, 4 if include_background else 3)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, atol=ATOL_SURFACE, equal_nan=True)


def test_native_edt_and_erosion_match_scipy(rng):
    mask = rng.random((21, 17, 13)) > 0.8
    np.testing.assert_allclose(native.edt(mask), ndimage.distance_transform_edt(~mask),
                               atol=1e-5)
    blob = _blobs(rng, (21, 17, 13), 2) == 1
    np.testing.assert_array_equal(native.binary_erosion(blob),
                                  ndimage.binary_erosion(blob, border_value=1))
    with pytest.raises(ValueError, match="3-D"):
        native.edt(mask[0])
