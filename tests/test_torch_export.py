"""Serving bundles as exported programs (`miseg_tpu_torch.serve`): the
counterparts of the nine tests of `tests/test_export.py`, each held
against the JAX package's `export_bundle` / `ServedModel` on the same
weights (seeded from numpy, bridged by `weights.state_dict_from_jax`).

Two models: JAX's `tiny` UNet of `tests/test_export.py` (16^3 ROI; its
norms are K1 + K2) and a small C-Swin-UNETR (feature_size 12, 32^3 ROI),
whose window runs all five kernels as `miseg::` ops.  On the CPU the ops
run the plain versions, so the port's window program (and its baked
form) is held to the live port model at atol 1e-5 in f32, and to JAX's
served window at atol 2e-4, the bound of the model tests and of
`tests/test_torch_serve_http.py`.  A volume program is held to the
generic inferer over the live model at atol 1e-5, and a served volume to
JAX's at 5e-4, the bound `tests/test_torch_serve_http.py` holds volume
logits to: blended over several windows, JAX's own f32 error adds up (a
34x32x40 C-Swin-UNETR volume sat 2.15e-4 from JAX's, and within 1e-5 of
the live port model).
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params

from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.serve import export_bundle as jax_export_bundle
from miseg_tpu.serve import load_bundle as jax_load_bundle
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.inferers import SlidingWindowInferer
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.serve import _window_fn, export_bundle, load_bundle
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL = 1e-5       # the port's programs against the live port model, f32
ATOL_JAX = 2e-4   # a window against JAX's served bundle
ATOL_JAX_VOLUME = 5e-4   # a volume against JAX's served bundle
MODELS = {
    # tests/test_export.py's `tiny`
    "unet": dict(model_name="unet", roi_x=16, roi_y=16, roi_z=16, out_channels=2,
                 feature_size=[8], num_layers=2, strides=[2], num_res_units=1,
                 encoder_norm_name="instance_cond", decoder_norm_name="instance",
                 no_amp=True, precision="fp32"),
    "swin_unetr": dict(model_name="swin_unetr", roi_x=32, roi_y=32, roi_z=32, out_channels=3,
                       feature_size=[12], num_heads=2, encoder_norm_name="instance_cond",
                       vit_norm_name="instance_cond", decoder_norm_name="instance",
                       no_amp=True, precision="fp32"),
}
# an exported volume shape (not grid-aligned: the program pads and crops)
# and one that matches no program
VOLUME = {"unet": (20, 20, 20), "swin_unetr": (40, 36, 32)}
OTHER = {"unet": (24, 20, 24), "swin_unetr": (34, 32, 40)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request, tmp_path_factory):
    """The JAX model and params, the port model on the same weights, the
    port's argument-form and baked bundles with one volume program, and
    JAX's argument-form bundle with the same volume program, loaded."""
    name = request.param
    root = tmp_path_factory.mktemp(f"export_{name}")
    roi = tuple(MODELS[name][k] for k in ("roi_x", "roi_y", "roi_z"))
    jcfg, cfg = JConfig(**MODELS[name]), Config(**MODELS[name])
    jmodel = jax_model_from_config(jcfg)
    params = seeded_params(jmodel, jnp.zeros((1, *roi, 1)), jnp.zeros((1,), jnp.int32))
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    shapes = [VOLUME[name]]
    arg = export_bundle(cfg, model.state_dict(), root / "arg", platforms=("cpu",),
                        volume_shapes=shapes)
    baked = export_bundle(cfg, model.state_dict(), root / "baked", platforms=("cpu",),
                          volume_shapes=shapes, bake_params=True)
    jserved = jax_load_bundle(jax_export_bundle(jcfg, params, root / "jax", platforms=("cpu",),
                                                volume_shapes=shapes))
    return {"name": name, "cfg": cfg, "jcfg": jcfg, "params": params, "model": model,
            "roi": roi, "arg": arg, "baked": baked, "jserved": jserved,
            "served": load_bundle(arg, "cpu"), "served_baked": load_bundle(baked, "cpu"),
            "root": root}


def _inferer(s, mode="gaussian"):
    """The generic inferer over the live port model."""
    cfg = s["cfg"]
    return SlidingWindowInferer(_window_fn(s["model"], torch.float32), s["roi"],
                                cfg.sw_batch_size, cfg.infer_overlap, mode,
                                out_channels=cfg.out_channels, device="cpu")


def _volume(shape, seed):
    return np.random.default_rng(seed).normal(size=(1, *shape, 1)).astype(np.float32)


def _jax_err(s, got, vol, mods, **kw) -> float:
    """max |diff| of a served volume against JAX's on the same volume."""
    return max_err(got, np.asarray(s["jserved"].predict(jnp.asarray(vol), jnp.asarray(mods),
                                                         **kw)))


def test_bundle_roundtrip_window_forward(setup):
    """The files, the meta, and the window program for both modalities
    against the live model and JAX's served window."""
    s = setup
    assert (s["arg"] / "window_fn.pt2").exists() and (s["arg"] / "weights.pt").exists()
    assert not (s["arg"] / "window_fn_baked.pt2").exists()
    meta = json.loads((s["arg"] / "meta.json").read_text())
    assert meta["bundle_version"] == 3
    assert meta["roi"] == list(s["roi"]) and meta["out_channels"] == s["cfg"].out_channels
    window = _volume(s["roi"], 1)
    for mod in (0, 1):
        mods = np.full((1,), mod, np.int32)
        got = s["served"](window, mods)
        with torch.inference_mode():
            want = s["model"](torch.from_numpy(window), torch.from_numpy(mods))
        assert max_err(got, want) <= ATOL
        assert max_err(got, s["jserved"](jnp.asarray(window), jnp.asarray(mods))) <= ATOL_JAX


def test_bundle_volume_predict_matches_inferer(setup):
    """A volume no program covers, with constant blend, through the window
    program in the generic inferer."""
    s = setup
    vol = _volume(OTHER[s["name"]], 2)
    mods = np.ones((1,), np.int32)
    got = s["served"].predict(vol, mods, mode="constant")
    want = _inferer(s, "constant")(torch.from_numpy(vol), torch.from_numpy(mods))
    assert got.shape == want.shape == (1, *OTHER[s["name"]], s["cfg"].out_channels)
    assert max_err(got, want) <= ATOL
    assert _jax_err(s, got, vol, mods, mode="constant") <= ATOL_JAX_VOLUME


def test_multi_platform_lowering_from_cpu_host(setup, tmp_path):
    """A CPU host exports for the card and the CPU: JAX's ("tpu", "cpu")
    names the card as "cuda"; the bundle loads on the CPU and answers;
    a bundle for the card alone refuses the CPU, and an unknown platform
    raises."""
    s = setup
    out = export_bundle(s["cfg"], s["model"].state_dict(), tmp_path / "b",
                        platforms=("tpu", "cpu"))
    served = load_bundle(out, "cpu")
    assert served.meta["platforms"] == ["cuda", "cpu"]
    window = np.zeros((1, *s["roi"], 1), np.float32)
    assert torch.isfinite(served(window, np.zeros((1,), np.int32))).all()
    cuda_only = export_bundle(s["cfg"], s["model"].state_dict(), tmp_path / "c",
                              platforms=("cuda",))
    assert json.loads((cuda_only / "meta.json").read_text())["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not for cpu"):
        load_bundle(cuda_only, "cpu")
    with pytest.raises(ValueError, match="unknown export platform 'rocm'"):
        export_bundle(s["cfg"], s["model"].state_dict(), tmp_path / "d", platforms=("rocm",))


def test_amp_bundle_stores_compute_dtype_params(setup, tmp_path):
    """Under amp the weights ship in bf16 and the program computes in
    bf16: against the f32 live model and JAX's bf16 bundle at 0.1."""
    s = setup
    amp = dict(no_amp=False, precision="bf16")
    out = export_bundle(s["cfg"].replace(**amp), s["model"].state_dict(), tmp_path / "b",
                        platforms=("cpu",))
    served = load_bundle(out, "cpu")
    assert served.meta["params_dtype"] == served.meta["compute_dtype"] == "bfloat16"
    weights = torch.load(out / "weights.pt", weights_only=True)
    assert all(v.dtype == torch.bfloat16 for v in weights.values() if v.is_floating_point())
    window = _volume(s["roi"], 5)
    mods = np.zeros((1,), np.int32)
    got = served(window, mods)
    assert got.dtype == torch.float32
    with torch.inference_mode():
        want = s["model"](torch.from_numpy(window), torch.from_numpy(mods))
    assert max_err(got, want) <= 0.1
    jout = jax_export_bundle(s["jcfg"].replace(**amp), s["params"], tmp_path / "j",
                             platforms=("cpu",))
    jgot = jax_load_bundle(jout)(jnp.asarray(window), jnp.asarray(mods))
    assert max_err(got, jgot) <= 0.1


def test_bundle_version_guard(setup, tmp_path):
    """A newer bundle raises; a version-2 bundle (no programs, no
    platforms) still loads by rebuilding the model, and answers as the
    version-3 one does."""
    s = setup
    meta = json.loads((s["arg"] / "meta.json").read_text())
    newer = tmp_path / "newer"
    newer.mkdir()
    (newer / "meta.json").write_text(json.dumps({**meta, "bundle_version": 99}))
    with pytest.raises(ValueError, match="newer"):
        load_bundle(newer, "cpu")
    v2 = tmp_path / "v2"
    v2.mkdir()
    old = {k: v for k, v in meta.items()
           if k not in ("platforms", "window_baked", "volume_programs")}
    (v2 / "meta.json").write_text(json.dumps({**old, "bundle_version": 2}))
    (v2 / "weights.pt").symlink_to(s["arg"] / "weights.pt")
    served = load_bundle(v2, "cpu")
    assert served.model is not None and served.form == "arguments"
    window = _volume(s["roi"], 7)
    mods = np.ones((1,), np.int32)
    assert max_err(served(window, mods), s["served"](window, mods)) <= ATOL


def test_volume_level_export_fast_path(setup):
    """A listed (shape, batch 1, overlap, mode) takes its volume program;
    any mismatch takes the window path.  Both against the generic
    inferer over the live model, and JAX's served bundle."""
    s = setup
    cfg, shape = s["cfg"], VOLUME[s["name"]]
    tag = "x".join(map(str, shape))
    meta = json.loads((s["arg"] / "meta.json").read_text())
    assert meta["volume_programs"] == [{
        "tag": tag, "spatial": list(shape), "batch": 1, "mode": "gaussian",
        "overlap": cfg.infer_overlap, "params_baked": False}]
    assert meta["volume_programs"] == s["jserved"].meta["volume_programs"]
    assert (s["arg"] / f"volume_{tag}.npz").exists()
    assert not (s["arg"] / f"volume_{tag}.pt2").exists()

    served = s["served"]
    vol = _volume(shape, 3)
    mods = np.ones((1,), np.int32)
    assert served.volume_program(shape, 1, cfg.infer_overlap, "gaussian") is not None
    assert served.loaded_volume_programs() == [tag]
    got = served.predict(vol, mods)
    want = _inferer(s)(torch.from_numpy(vol), torch.from_numpy(mods))
    assert max_err(got, want) <= ATOL
    assert _jax_err(s, got, vol, mods) <= ATOL_JAX_VOLUME

    assert served.volume_program(OTHER[s["name"]], 1, cfg.infer_overlap, "gaussian") is None
    assert served.volume_program(shape, 1, cfg.infer_overlap, "constant") is None
    assert served.volume_program(shape, 1, 0.25, "gaussian") is None
    assert served.volume_program(shape, 2, cfg.infer_overlap, "gaussian") is None
    vol2 = _volume(OTHER[s["name"]], 4)
    got2 = served.predict(vol2, mods)
    assert max_err(got2, _inferer(s)(torch.from_numpy(vol2), torch.from_numpy(mods))) <= ATOL
    assert _jax_err(s, got2, vol2, mods) <= ATOL_JAX_VOLUME


def test_volume_export_baked_params(setup):
    """Under `bake_params` the volume program runs the baked window
    program and answers what the argument form answers."""
    s = setup
    shape = VOLUME[s["name"]]
    meta = json.loads((s["baked"] / "meta.json").read_text())
    assert meta["volume_programs"][0]["params_baked"] is True
    baked, arg = s["served_baked"], s["served"]
    vol = _volume(shape, 4)
    mods = np.zeros((1,), np.int32)
    assert baked.volume_program(shape, 1, s["cfg"].infer_overlap, "gaussian") is not None
    got = baked.predict(vol, mods)
    assert max_err(got, arg.predict(vol, mods)) <= ATOL
    assert _jax_err(s, got, vol, mods) <= ATOL_JAX_VOLUME


def test_baked_window_program_fallback(setup):
    """`bake_params` ships `window_fn_baked.pt2`, which carries the
    weights: the bundle loads it alone by default (its `state_dict()`
    read from `weights.pt` on the CPU), and `__call__` and the
    every-shape fallback run it, against the live model and JAX.  The
    argument form loads on request; a bundle without the baked program
    refuses it."""
    s = setup
    out = s["baked"]
    assert (out / "window_fn_baked.pt2").exists()
    assert json.loads((out / "meta.json").read_text())["window_baked"] is True
    served = s["served_baked"]
    assert served.form == "baked" and served._state is None
    weights = served.state_dict()
    assert weights.keys() == s["model"].state_dict().keys()
    assert all(torch.equal(weights[k], v) for k, v in s["served"].state_dict().items())
    assert load_bundle(out, "cpu", form="arguments").form == "arguments"
    with pytest.raises(ValueError, match="not 'baked'"):
        load_bundle(s["arg"], "cpu", form="baked")
    window = _volume(s["roi"], 6)
    mods = np.zeros((1,), np.int32)
    got = served(window, mods)
    with torch.inference_mode():
        want = s["model"](torch.from_numpy(window), torch.from_numpy(mods))
    assert max_err(got, want) <= ATOL
    assert max_err(got, s["jserved"](jnp.asarray(window), jnp.asarray(mods))) <= ATOL_JAX
    vol = _volume(OTHER[s["name"]], 8)
    got2 = served.predict(vol, mods)
    assert max_err(got2, _inferer(s)(torch.from_numpy(vol), torch.from_numpy(mods))) <= ATOL
    assert _jax_err(s, got2, vol, mods) <= ATOL_JAX_VOLUME


def test_fallback_warning_logged_once(setup, caplog, tmp_path):
    """A volume no program covers warns once per shape, in either form
    (the port's fast path is the captured volume program, which a baked
    window program does not give); a bundle whose listed program lost its
    `.npz` warns and answers through the window path."""
    s = setup
    vol = np.zeros((1, *OTHER[s["name"]], 1), np.float32)
    mods = np.zeros((1,), np.int32)
    for served in (load_bundle(s["arg"], "cpu"), load_bundle(s["baked"], "cpu")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="miseg_tpu_torch.serve"):
            served.predict(vol, mods)
            served.predict(vol, mods)   # same shape: logged once
        warned = [r for r in caplog.records if "matches no volume program" in r.getMessage()]
        assert len(warned) == 1

    partial = tmp_path / "partial"
    partial.mkdir()
    for f in s["arg"].iterdir():
        if f.suffix != ".npz":
            (partial / f.name).symlink_to(f)
    served = load_bundle(partial, "cpu")
    shape = VOLUME[s["name"]]
    with pytest.warns(UserWarning, match="unusable"):
        assert served.volume_program(shape, 1, s["cfg"].infer_overlap, "gaussian") is None
    vol = _volume(shape, 9)
    assert max_err(served.predict(vol, mods), s["served"].predict(vol, mods)) <= ATOL
