"""Port sliding-window inference and serving bundles against the JAX
package (CPU).  The predictor is a fixed 1x1 linear map plus a
per-modality offset, cheap and deterministic, so the comparison isolates
tiling, blending, padding and cropping (atol 1e-5, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, t

from miseg_tpu import inferers as JI
from miseg_tpu_torch import inferers as TI
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.serve import _window_fn, load_bundle, save_bundle

torch.set_num_threads(1)
ATOL = 1e-5
ROI = (32, 32, 32)


def _linear_map(rng):
    w = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    return w, b


@pytest.mark.parametrize("sw_batch_size", [1, 2])
@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_inferer_matches_jax(rng, mode, sw_batch_size):
    w, b = _linear_map(rng)
    vol = rng.standard_normal((2, 40, 48, 56, 2)).astype(np.float32)
    mods = np.array([0, 1], np.int32)

    def jpredict(x, m):
        return x @ w + b + 0.5 * m[:, None, None, None, None].astype(jnp.float32)

    def tpredict(x, m):
        return x @ t(w) + t(b) + 0.5 * m[:, None, None, None, None].float()

    want = JI.SlidingWindowInferer(jpredict, ROI, sw_batch_size, 0.5, mode,
                                   out_channels=3)(jnp.asarray(vol), jnp.asarray(mods))
    got = TI.SlidingWindowInferer(tpredict, ROI, sw_batch_size, 0.5, mode,
                                  out_channels=3, device="cpu")(t(vol), t(mods))
    assert got.shape == (2, 40, 48, 56, 3)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("overlap", [0.5, 0.25, 0.0])
def test_window_grid_matches_jax(overlap):
    for size in [(40, 48, 56), (224, 224, 224), (160, 192, 128)]:
        interval = TI.scan_interval((96, 96, 96), overlap)
        assert interval == JI.scan_interval((96, 96, 96), overlap)
        assert np.array_equal(TI.dense_patch_starts(size, (96, 96, 96), interval),
                              JI.dense_patch_starts(size, (96, 96, 96), interval))
    assert np.array_equal(TI.gaussian_importance(ROI), JI.gaussian_importance(ROI))


_CFG = dict(model_name="swin_unetr", out_channels=3, feature_size=[12],
            num_heads=2, roi_x=32, roi_y=32, roi_z=32, sw_batch_size=2,
            encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
            decoder_norm_name="instance", no_amp=True)


def test_bundle_roundtrip_matches_direct_inferer(rng, tmp_path):
    cfg = Config(**_CFG)
    model = model_from_config(cfg, device="cpu")
    save_bundle(cfg, model.state_dict(), tmp_path / "bundle")
    served = load_bundle(tmp_path / "bundle", device="cpu")
    vol = rng.standard_normal((1, 40, 32, 36, 1)).astype(np.float32)
    got = served.predict(vol, [1])
    direct = TI.SlidingWindowInferer(
        _window_fn(model, torch.float32), ROI, cfg.sw_batch_size,
        cfg.infer_overlap, "gaussian", out_channels=3, device="cpu")(
            t(vol), torch.tensor([1], dtype=torch.int32))
    assert got.shape == (1, 40, 32, 36, 3)
    assert torch.isfinite(got).all()
    assert max_err(got, direct) == 0.0


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(**_CFG)
    save_bundle(cfg, model_from_config(cfg, device="cpu").state_dict(),
                tmp_path / "bundle")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bundle(tmp_path / "bundle")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.SlidingWindowInferer(lambda w, m: w, ROI, out_channels=1)
