"""2-D models in the port (`spatial_dims=2`) against the JAX package on
bridged weights (CPU, f32).

* The window utilities: `window_partition`/`window_reverse` round trips,
  the shifted-window region ids against JAX's `window_region_ids` (and
  the additive mask they stand for against `compute_mask`), the 2-D
  relative-position index against JAX's; K5's plain version and K1/K2's
  wrappers on 2-D callers.
* PatchMerging's 2-D slice order: the reference iterates `(i, j)` but
  slices `[j::2, i::2]` (miseg_tpu/nn/swin.py:248-252), in both variants;
  the natural order is the negative control.
* Whole models through `model_from_config` at a 64x64 ROI: C-Swin-UNETR
  (fs 12, heads 2), C-UNETR (hidden 96), C-UNet, UNetVanilla, and
  SSLHead's three decoders; logits at atol 2e-4, the 3-D models' bound.
* One AdamW `Trainer.train_step` of the 2-D C-Swin-UNETR and of a
  batch-norm C-UNet against JAX's jitted `value_and_grad` + optax update,
  with the 3-D step tests' gates (loss, gradient leaves and their sum, the
  W5 parameter bound, running statistics at 1e-6).
* The 2-D sliding-window inferer (gaussian and constant, a slice no
  window grid divides, sw_batch_size 2) against JAX's.
* A 2-D bundle: exported, loaded and predicted, against the live model.
* The data layer stays 3-D, as JAX's: a 2-D Config fails in the train
  loader with the exception class JAX's raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.data import multi_modal as JMM
from miseg_tpu.inferers import SlidingWindowInferer as JInferer
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.models.ssl_head import SSLHead as JSSLHead
from miseg_tpu.nn.swin import PatchMergingV2 as JPatchMerging
from miseg_tpu.ops import window as JW
from miseg_tpu.ops.rel_bias import rel_pos_index as j_rel_pos_index
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data import multi_modal as MM
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.inferers import SlidingWindowInferer
from miseg_tpu_torch.models import SSLHead, model_from_config
from miseg_tpu_torch.nn.swin import PatchMergingV2
from miseg_tpu_torch.ops import window as W
from miseg_tpu_torch.ops.kernels import fused_norm
from miseg_tpu_torch.ops.kernels.window_attention import window_attention
from miseg_tpu_torch.ops.rel_bias import rel_pos_index
from miseg_tpu_torch.serve import export_bundle, load_bundle
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_MODEL = 2e-4
ATOL_BLOCK = 1e-5
ATOL_LOSS = 1e-5
ATOL_STATS = 1e-6
ATOL_LEAF, ATOL_LEAF_SUM = 5e-5, 1e-3
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
SIZE = 64
_NORMS = dict(encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
              decoder_norm_name="instance")
_2D = dict(spatial_dims=2, roi_x=SIZE, roi_y=SIZE, out_channels=4, **_NORMS)
CASES = {
    "swin_unetr": dict(_2D, model_name="swin_unetr", feature_size=[12], num_heads=2),
    "unetr": dict(_2D, model_name="unetr", feature_size=[16], hidden_size=96, mlp_dim=192,
                  num_heads=12),
    "unet": dict(_2D, model_name="unet", feature_size=[4]),
    "unet_batch": dict(_2D, model_name="unet", feature_size=[4], encoder_norm_name="batch",
                       decoder_norm_name="batch"),
    "unet_vanilla": dict(_2D, model_name="unet_vanilla", feature_size=[4, 8, 8, 16, 16],
                         strides=[1, 2, 2, 2, 1], num_res_units=3),
}
_STEP = dict(criterion="dice_focal", optim_name="adamw", lr=1e-4, reg_weight=1e-5,
             no_amp=True)


# ------------------------------------------------------------ windows ----

@pytest.mark.parametrize("dims,window,shift", [((14, 21), (7, 7), (3, 3)),
                                               ((14, 14), (7, 7), (0, 3)),
                                               ((8, 8), (4, 4), (2, 2))])
def test_window_ops_2d_match_jax(dims, window, shift):
    x = np.random.default_rng(0).standard_normal((2, *dims, 3)).astype(np.float32)
    got = W.window_partition(t(x), window)
    want = JW.window_partition(jnp.asarray(x), window)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(W.window_reverse(got, window, (2, *dims)).numpy(), x)
    ids = W.window_region_ids(dims, window, shift)
    jids = JW.window_region_ids(dims, window, shift)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    # the additive mask the ids stand for is the reference's
    mask = np.where(ids.numpy()[:, None, :] != ids.numpy()[:, :, None], -100.0, 0.0)
    assert np.array_equal(mask, JW.compute_mask(dims, window, shift))
    # a dim below the window clips it and zeroes its shift
    assert W.get_window_size((5, 9), (7, 7), (3, 3)) == JW.get_window_size(
        (5, 9), (7, 7), (3, 3))


@pytest.mark.parametrize("window", [(7, 7), (4, 6)])
def test_rel_pos_index_2d_matches_jax(window):
    got = rel_pos_index(window)
    assert got.shape == (np.prod(window),) * 2
    assert np.array_equal(got, np.asarray(j_rel_pos_index(window)))
    assert got.max() == (2 * window[0] - 1) * (2 * window[1] - 1) - 1


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_takes_2d_windows(masked):
    """K5's wrapper at N = 49 (7x7 windows), head dim 16: on the CPU its
    plain version, against an f32 softmax attention written out."""
    rng = np.random.default_rng(1)
    nw, b, h, hd = 4, 2, 3, 16
    q, k, v = (t(rng.standard_normal((b * nw, 49, h * hd)).astype(np.float32))
               for _ in range(3))
    bias = t(0.02 * rng.standard_normal((h, 49, 49)).astype(np.float32))
    ids = W.window_region_ids((14, 14), (7, 7), (3, 3)) if masked else None
    got = window_attention(q, k, v, bias, ids, num_heads=h)
    s = torch.einsum("bnhd,bmhd->bhnm", q.reshape(-1, 49, h, hd),
                     k.reshape(-1, 49, h, hd)) * hd ** -0.5 + bias
    if masked:
        neq = (ids[:, None, :] != ids[:, :, None]).float() * -100.0
        s = (s.reshape(b, nw, h, 49, 49) + neq[None, :, None]).reshape(b * nw, h, 49, 49)
    want = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1),
                        v.reshape(-1, 49, h, hd)).reshape(b * nw, 49, -1)
    assert max_err(got, want) <= ATOL_BLOCK


def test_instance_norm_wrappers_take_2d_callers():
    """K1 + K2 through `instance_norm_act` on `[B, H, W, C]` (the wrapper
    flattens to `[B, H*W, C]`), with banks, an add and a leaky relu."""
    rng = np.random.default_rng(2)
    x = t(rng.standard_normal((2, 12, 10, 8)).astype(np.float32) * 3 + 1)
    add = t(rng.standard_normal(x.shape).astype(np.float32))
    gamma = t(1 + 0.1 * rng.standard_normal((2, 8)).astype(np.float32))
    beta = t(0.1 * rng.standard_normal((2, 8)).astype(np.float32))
    styles = torch.tensor([1, 0])
    got = fused_norm.instance_norm_act(x, gamma, beta, styles, negative_slope=0.01, add=add)
    mean = x.mean((1, 2), keepdim=True)
    var = (x - mean).square().mean((1, 2), keepdim=True)
    y = (x - mean) / torch.sqrt(var + 1e-5) * gamma[styles][:, None, None] \
        + beta[styles][:, None, None] + add
    assert got.shape == x.shape
    assert max_err(got, torch.where(y >= 0, y, 0.01 * y)) <= ATOL_BLOCK


# ----------------------------------------------------- patch merging ----

@pytest.mark.parametrize("legacy", [True, False])
def test_patch_merging_2d_slice_order_matches_jax(legacy):
    """2-D merging concatenates `[j::2, i::2]` over `(i, j)` in product
    order, in both variants, over an odd size (padded)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 6, 4)).astype(np.float32)
    mods = np.array([1, 0], np.int32)
    norm = ("instance_cond", {"num_styles": 2, "affine": True})
    jmod = JPatchMerging(dim=4, norm=norm, legacy=legacy)
    params = seeded_params(jmod, jnp.asarray(x), jnp.asarray(mods))
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mods))
    mod = PatchMergingV2(4, norm, legacy=legacy, spatial_dims=2, device="cpu")
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = mod(t(x), t(mods))
        assert got.shape == (2, 4, 3, 8)
        assert max_err(got, want) <= ATOL_BLOCK
        # the natural order [i::2, j::2] computes something else
        mod.offsets = [(i, j) for i in (0, 1) for j in (0, 1)]
        assert max_err(mod(t(x), t(mods)), want) > 0.1


# ------------------------------------------------------- whole models ----

@functools.lru_cache(maxsize=None)
def _jax_model(case: str):
    """(x, modalities, params, JAX logits) of a 2-D case, once per worker."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jmodel = jax_model_from_config(JConfig(**CASES[case]))
    params = seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods))
    variables = {"params": params}
    if "batch" in case:
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x, mods)["batch_stats"]
        r = np.random.default_rng(1)
        variables["batch_stats"] = jax.tree.map(
            lambda s: r.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)
    want = np.asarray(jax.jit(lambda v, a, m: jmodel.apply(v, a, m))(variables, x, mods))
    return x, mods, variables, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_2d_matches_jax(case):
    x, mods, variables, want = _jax_model(case)
    cfg = Config(**CASES[case])
    assert cfg.roi == (SIZE, SIZE)
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats")), strict=True)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Module)
             and getattr(m, "weight", None) is not None and m.weight.ndim > 2]
    assert convs and all(m.weight.ndim == 4 for m in convs)   # every conv is 2-D
    with torch.no_grad():
        got = model(t(x), t(mods))
    err = max_err(got, want)
    print(f"2-D {case} {SIZE}^2 logits max |port - jax| = {err:.3e} "
          f"(|logits| <= {np.abs(want).max():.2f})")
    assert got.shape == (2, SIZE, SIZE, 4) and err <= ATOL_MODEL


@pytest.mark.parametrize("upsample", ["vae", "deconv", "large_kernel_deconv"])
def test_ssl_head_2d_matches_jax(upsample):
    shape = (1, 64, 32, 1)    # the bottom stage holds the 2 tokens the heads read
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jmodel = JSSLHead(feature_size=12, upsample=upsample, dim=192, spatial_dims=2)
    params = seeded_params(jmodel, jnp.zeros(shape))
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, jnp.asarray(x))
    model = SSLHead(feature_size=12, upsample=upsample, dim=192, spatial_dims=2,
                    device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model(t(x))
    assert [tuple(g.shape) for g in got] == [(1, 4), (1, 512), shape]
    for name, g, w in zip(("rotation", "contrastive", "reconstruction"), got, want):
        assert max_err(g, w) <= ATOL_MODEL, f"{upsample} {name}: {max_err(g, w):.2e}"


# ----------------------------------------------------------- one step ----

@functools.lru_cache(maxsize=None)
def _jax_step(case: str):
    """JAX's loss, gradients, parameters after one AdamW update and new
    `batch_stats` for a 2-D case."""
    cfg = dict(CASES[case], **_STEP)
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    label = rng.integers(0, 4, (2, SIZE, SIZE)).astype(np.int32)
    mods = np.array([1, 0], np.int32)
    jcfg = JConfig(**cfg)
    jmodel = jax_model_from_config(jcfg)
    _, _, variables, _ = _jax_model(case)
    loss_fn = JL.loss_from_config(jcfg)
    stats = variables.get("batch_stats")

    def loss_of(p):
        if stats is None:
            logits = jmodel.apply({"params": p}, image, mods, train=True)
            return loss_fn(logits.astype(jnp.float32), label), {}
        logits, new_vars = jmodel.apply({"params": p, "batch_stats": stats}, image, mods,
                                        train=True, mutable=["batch_stats"])
        return loss_fn(logits.astype(jnp.float32), label), new_vars

    jparams = jax.tree.map(jnp.asarray, variables["params"])
    (loss, new_vars), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jparams)
    tx = j_optimizer_from_config(jcfg)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, jparams)
    new_stats = jax.tree.map(np.array, dict(new_vars).get("batch_stats", {}))
    return dict(batch={"image": image, "label": label[..., None], "modality": mods},
                cfg=cfg, start=state_dict_from_jax(variables["params"], stats),
                loss=float(loss), grads=state_dict_from_jax(jax.tree.map(np.array, grads)),
                new=state_dict_from_jax(jax.tree.map(np.array, new), new_stats))


@pytest.mark.parametrize("case", ["swin_unetr", "unet_batch"])
def test_train_step_2d_matches_jax(case):
    ref = _jax_step(case)
    trainer = engine.Trainer(Config(**ref["cfg"]), device="cpu")
    state = trainer.init_state(ref["start"])
    state, loss = trainer.train_step(state, ref["batch"])
    loss_err = abs(float(loss) - ref["loss"])
    gaps = {n: max_err(p.grad, ref["grads"][n]) for n, p in state.params.items()}
    worst = max(gaps, key=gaps.get)
    print(f"2-D {case} step: loss {float(loss):.6f} |diff| {loss_err:.2e}; gradient gap "
          f"summed over {len(gaps)} leaves {sum(gaps.values()):.3e}, worst {worst} "
          f"{gaps[worst]:.2e}")
    assert state.step == 1 and loss_err <= ATOL_LOSS
    assert sum(gaps.values()) <= ATOL_LEAF_SUM and gaps[worst] <= ATOL_LEAF
    # the gates bite: the gradients are not all near zero
    assert sum(float(g.abs().max()) for g in ref["grads"].values()) > ATOL_LEAF_SUM
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref["new"][n].numpy(),
                                   rtol=RTOL_STEP, atol=ATOL_STEP, err_msg=n)
    assert len(state.buffers) == (26 if "batch" in case else 0)
    for n, b in state.buffers.items():
        np.testing.assert_allclose(b.numpy(), ref["new"][n].numpy(), rtol=1e-5,
                                   atol=ATOL_STATS, err_msg=n)


# ------------------------------------------------------------ inferer ----

@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_sliding_window_2d_matches_jax(mode):
    """A window function that depends on the whole window (its mean), so
    the blend of overlapping windows shows, over a 70x50 slice (padded to
    the grid) at ROI 32x32, overlap 0.5, two windows a group."""
    x = np.random.default_rng(8).standard_normal((2, 70, 50, 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)

    def jfn(w, m):
        return jnp.concatenate([w - w.mean(axis=(1, 2), keepdims=True), 2 * w], -1)

    def fn(w, m):
        return torch.cat([w - w.mean(dim=(1, 2), keepdim=True), 2 * w], -1)

    want = JInferer(jfn, (32, 32), 2, 0.5, mode, out_channels=2)(jnp.asarray(x),
                                                                 jnp.asarray(mods))
    got = SlidingWindowInferer(fn, (32, 32), 2, 0.5, mode, out_channels=2,
                               device="cpu")(t(x), t(mods))
    assert got.shape == (2, 70, 50, 2)
    assert max_err(got, want) <= ATOL_BLOCK


def test_bundle_2d_predicts_the_live_model(tmp_path):
    """An f32 2-D C-Swin-UNETR exported (window program through
    torch.export), loaded and predicting a 100x90 slice: the live model's
    inferer."""
    cfg = Config(**dict(CASES["swin_unetr"], infer_overlap=0.5, no_amp=True))
    model = model_from_config(cfg, device="cpu")
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    export_bundle(cfg, sd, tmp_path / "b", platforms=("cpu",))
    served = load_bundle(tmp_path / "b", device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).random((1, 100, 90, 1), np.float32))
    mods = torch.tensor([1])
    got = served.predict(x, mods, mode="gaussian")
    inferer = SlidingWindowInferer(lambda w, m: model(w, m), cfg.roi, cfg.sw_batch_size,
                                   0.5, "gaussian", out_channels=4, device="cpu")
    with torch.no_grad():
        want = inferer(x, mods)
    assert got.shape == (1, 100, 90, 4)
    assert max_err(got, want) <= ATOL_MODEL


# --------------------------------------------------------- data layer ----

def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the class is what is compared
        return type(e)
    return None


def test_data_layer_stays_3d_like_jax(tmp_path):
    """JAX's data layer is 3-D only (miseg_tpu/data/transforms.py:417):
    with `spatial_dims=2` both packages' train loaders fail on the first
    batch, with the same exception class; their eval transforms too."""
    make_synthetic_dataset(tmp_path, shape=(22, 20, 18), num_classes=4, n_train=1,
                           n_val=1, n_test=1, spacing=(1.0, 1.0, 1.0), seed=4)
    kw = dict(spatial_dims=2, roi_x=16, roi_y=16, data_dirs=[str(tmp_path)] * 2,
              json_lists=["CT.json", "MR.json"], batch_size=1, num_workers=0,
              cache_num=4)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    want = _raised(lambda: next(iter(JMM.MultiModalData(jcfg).train_dataloader())))
    got = _raised(lambda: next(iter(MM.MultiModalData(cfg).train_dataloader())))
    print(f"2-D Config in the train loader: JAX raises {want}, the port {got}")
    assert want is not None and got is want
    item = {"image": str(tmp_path / "ct_train" / "ct_train_1001_image.nii.gz"),
            "label": str(tmp_path / "ct_train" / "ct_train_1001_label.nii.gz"),
            "modality": 0}
    want = _raised(lambda: JMM.eval_transforms(jcfg)(dict(item)))
    got = _raised(lambda: MM.eval_transforms(cfg)(dict(item)))
    assert want is not None and got is want
