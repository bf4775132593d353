"""Spatial partitioning in the port (`miseg_tpu_torch.parallel.spatial`) on
the CPU: gloo ranks as subprocesses (`tests/_torch_spatial_worker.py`),
spawned once for the module, two for the line `[2]` and four for `[4]`
and the ("data", "sp") mesh `[2, 2]`, each held to a timeout, against the
whole volume, one process and the JAX package.

* Placements, with no spawn: `spatial_spec` and `shard_spatial_batch`
  follow JAX's rules case by case (tests/test_spatial.py:21-42), D = 15
  included, and a rank's piece is JAX's shard on the same mesh
  coordinates.
* The pieces, at `[2]`: `halo_d` (every shape of halo a conv asks),
  `gather_d` / `slice_d`, `gather_rows`, `sum_over_line` and
  `merge_moments`, forward and backward, against autograd on the whole
  volume in f64; K4's D-halo mode (plain) through `spatial.conv3_halo`,
  without and with a prologue, slab by slab equal to the whole volume's
  conv and its merged columns, with the gradients of every leaf; K1's
  moments mode with the line's merge against the whole volume's columns,
  with W1's small-variance channel; and, in this process, K4's halo mode
  for each pair of edge flags against the whole volume and its backward
  against autograd through the plain version.
* Each loss of `losses.py` over the slabs equals the whole patch's, value
  and gradient.
* Steps: JAX's tiny C-UNet (tests/test_spatial.py:45-52, SGD) on `[2]`,
  `[4]` and `[2, 2]`, held to JAX's one-process step on the global batch
  through the weight bridge at JAX's tolerances (loss rtol 1e-5, params
  rtol 1e-4 / atol 1e-5), the applied gradients within 5e-5 a leaf, and
  every rank's masters bitwise equal.
* The swin: JAX's tiny swin forward (tests/test_spatial.py:148-176) on
  `[2]` against JAX's forward, tighter than JAX's own SP test; one SGD
  step, and one with dropout, attention dropout and drop-path on, held
  to the port's one process (JAX draws other masks); so the batch-norm
  C-UNet's step and running statistics, and group norm's merged
  statistics against the whole volume's.
* SP beside FSDP: the tiny C-UNet on `[2]` and `[4]` and an fs-24 swin on
  `[2]` with FSDP on the spatial line, a C-UNet whose patch (D 18) the
  level rule keeps whole, and the C-UNet on ("data", "sp") `[2, 2]` with
  FSDP on "data" and on "sp": each step held to the port's one process
  (the gates of the swin steps) and to JAX's step (those of the C-UNet
  steps), every leaf's gradient counted once; the gathered masters
  bitwise equal on every rank; a rank's bytes of masters and momentum one
  process's less the sharded leaves' share; and the checkpoint (gathered
  whole) restored and gathered again bit for bit, equal to one process's.
* Evaluation's window fan-out (`SlidingWindowInferer`'s `mesh`): over two
  and four ranks, with group counts the ranks do not divide (a rank that
  predicts only padded repeats, a short last group), the logits within
  1e-6 of one process's (on the CPU they are its bits) and within 1e-4 of
  JAX's fan-out inferer on its CPU mesh (tests/test_inferer.py:157),
  ⌈G/N⌉ predict calls a rank; none under `stitch_on_host`; and
  `Trainer.evaluate`'s metrics on `[2]` and `[2, 2]` equal to one
  process's (Dice equal, the rest within 1e-6), windows ⌈G/N⌉ a volume.
* Every model family: a tiny C-UNETR (fs 4, hidden 16, 64^3) on `[2]`,
  where the level rule shards its token level, on `[4]`, where it keeps
  it whole, and on ("data", "sp") `[2, 2]`; a tiny UNetVanilla of the
  README recipe's strides (1 2 2 2 1) on `[2]` and `[4]`, each with a
  whole level upsampled into a sharded one, and its batch-norm recipe on
  `[2]`; the tiny 2-D C-Swin-UNETR, C-UNETR, C-UNet and UNetVanilla on
  `[2]` (the slab is H): each step held to JAX's one-process step at the
  C-UNet's gates (the batch-norm recipe's running statistics too) and to
  the port's one process at the swin's, the masters bitwise equal; a
  C-UNETR with ViT dropout held to the port's one process; the tiny 2-D
  swin's forward against JAX's.
* The configurations SP once refused: beside tensor parallelism (with
  FSDP on the line too) and the pipeline flag, C-UNETR, UNetVanilla and
  2-D build and step as one process does; the spatial axis without
  `spatial_shard` builds and its step raises JAX's `shard_batch`
  KeyError; the field alone is taken.  No transposed conv of any model
  leaves its slab short (`conv_transpose`'s halo covers each).
"""

import functools
import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_bridge import seeded_params

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.inferers import SlidingWindowInferer as JSlidingWindowInferer
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.parallel import shard_spatial_batch as j_shard_spatial_batch
from miseg_tpu.parallel import spatial_spec as j_spatial_spec
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch import parallel
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.inferers import SlidingWindowInferer, window_starts
from miseg_tpu_torch.models.factory import _build
from miseg_tpu_torch.ops.kernels import fused_conv, fused_norm
from miseg_tpu_torch.parallel import spatial
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.utils.logging import MetricLogger
from miseg_tpu_torch.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_spatial_worker as W  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
SUITE_WORLDS = {"sp2": 2, "sp4": 4}
ATOL_LEAF = 5e-5


# ---------------------------------------------------------------- shared

@functools.lru_cache(maxsize=None)
def jax_model(model: str):
    """(JAX module, seeded params, batch statistics or None) of one of
    `W.MODELS`: a batch-norm model's running statistics drawn from a seed."""
    cfg = W.MODELS[model]
    batch = W.global_batch(cfg)
    jmodel = jax_model_from_config(JConfig(**cfg))
    args = jnp.asarray(batch["image"][:1]), jnp.asarray(batch["modality"][:1])
    stats = None
    if "batch" in cfg["encoder_norm_name"]:
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)["batch_stats"]
        rng = np.random.default_rng(2)
        stats = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                             shapes)
    return jmodel, seeded_params(jmodel, *args), stats


@functools.lru_cache(maxsize=None)
def start(model: str) -> dict:
    """The start of a model: JAX's seeded params (and statistics), bridged;
    the batch-norm C-UNet (held to the port's one process only) from the
    port's own init."""
    if model == "unet_batch":
        trainer = engine.Trainer(Config(**W.MODELS[model]), device="cpu")
        return {n: t.detach().clone() for n, t in trainer.state_dict(trainer.init_state()).items()}
    _, params, stats = jax_model(model)
    return state_dict_from_jax(params, stats)


@functools.lru_cache(maxsize=None)
def jax_step(model: str) -> dict:
    """JAX's one SGD step of a model on the global batch: loss, parameters,
    gradients and (of a batch-norm model) the new running statistics, as
    the port's names."""
    cfg = W.MODELS[model]
    jcfg = JConfig(**cfg)
    jmodel, params, stats = jax_model(model)
    loss_fn = JL.loss_from_config(jcfg)
    batch = W.global_batch(cfg)

    def loss_of(p):
        if stats is None:
            return loss_fn(jmodel.apply({"params": p}, batch["image"], batch["modality"],
                                        train=True).astype(jnp.float32), batch["label"]), {}
        logits, new_vars = jmodel.apply({"params": p, "batch_stats": stats}, batch["image"],
                                        batch["modality"], train=True, mutable=["batch_stats"])
        return loss_fn(logits.astype(jnp.float32), batch["label"]), new_vars["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    tx = j_optimizer_from_config(jcfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
    new_params = state_dict_from_jax(new)
    return {"loss": float(loss), "params": new_params,
            "grads": state_dict_from_jax(jax.tree.map(np.asarray, grads)),
            "buffers": {n: b for n, b in state_dict_from_jax(
                new, jax.tree.map(np.asarray, new_stats)).items() if n not in new_params}}


@functools.lru_cache(maxsize=None)
def one_process(case: str) -> dict:
    """The port's one process: one step of a case on the global batch; its
    bytes of masters and momentum, its tensors of state a parameter (the
    master and its momentum) and its momentum."""
    cfg = W.case_config(case, one_process=True)
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.init_state(start(W.CASES[case][0]))
    state, loss = trainer.train_step(state, W.global_batch(cfg))
    optimized = [p for g in state.optimizer.param_groups for p in g["params"]]
    return {"loss": float(loss),
            "params": {n: p.detach().clone() for n, p in state.params.items()},
            "grads": {n: p.grad.detach().clone() for n, p in state.params.items()},
            "buffers": {n: b.detach().clone() for n, b in state.buffers.items()},
            "state_bytes": trainer.state_bytes(state),
            "state_tensors": {n: 1 + sum(isinstance(v, torch.Tensor) and v.ndim > 0
                                         for v in state.optimizer.state[p].values())
                              for n, p in zip(trainer._opt_names(state), optimized)},
            "moments": W.momenta(trainer, state)}


@functools.lru_cache(maxsize=None)
def jax_swin_forward(model: str = "swin") -> np.ndarray:
    """JAX's tiny swin forward of tests/test_spatial.py:163-169 (its input
    and modality), or its 2-D twin's on `W.forward_input`, on the seeded
    params."""
    jmodel, params, _ = jax_model(model)
    fwd = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))
    return np.asarray(fwd(params, jnp.asarray(W.forward_input(model)),
                          jnp.asarray([1], jnp.int32)))


@functools.lru_cache(maxsize=None)
def refusal_one_process(name: str) -> dict:
    """The port's one process on a configuration SP once refused
    (`W.STEPPED`): one step from its own init on the global batch."""
    cfg = W.refusal_cases(2, one_process=True)[name]
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state, loss = trainer.train_step(trainer.init_state(), W.global_batch(cfg))
    return {"loss": float(loss),
            "grads": {n: p.grad.detach().clone() for n, p in state.params.items()}}


def spawn(suite: str, world: int, tmp: Path) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_spatial_worker.py"), suite, str(r),
         str(world), str(tmp / f"{suite}.rdzv"), str(tmp), str(tmp / "starts.pt")], env=env,
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both suites' ranks' results; JAX's references and the one process
    are computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("spatial")
    torch.save({m: start(m) for m in W.MODELS}, tmp / "starts.pt")
    procs = {suite: spawn(suite, world, tmp) for suite, world in SUITE_WORLDS.items()}
    logs = {}
    try:
        for model in ("unet", "swin24", "unet_whole", *{W.CASES[c][0] for c in JAX_CASES}):
            jax_step(model)
        jax_swin_forward()
        jax_swin_forward("swin_2d")
        for case in ("unet_batch_sp2", "swin_sp2", "swin_dropout_sp2", *W.FSDP_CASES,
                     *W.MODEL_CASES):
            one_process(case)
        for name in W.STEPPED:
            refusal_one_process(name)
        for name in W.FANOUT:
            fanout_one_process(name)
            for world in SUITE_WORLDS.values():
                jax_fanout(name, world)
        evaluate_one_process()
        for suite, ps in procs.items():
            logs[suite] = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for suite, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"{suite} rank {r} exited {p.returncode}:\n" \
                                      f"{logs[suite][r][-4000:]}"
    return {suite: [torch.load(tmp / f"{suite}_rank{r}.pt", weights_only=False)
                    for r in range(len(ps))] for suite, ps in procs.items()}


def _results(ranks, case: str) -> list:
    return ranks["sp2" if case in W.SUITES["sp2"] else "sp4"]


@functools.lru_cache(maxsize=None)
def fanout_one_process(name: str) -> torch.Tensor:
    """A `W.FANOUT` case's logits through the port's inferer in one process."""
    _, k, _ = W.FANOUT[name]
    x, mods = (torch.from_numpy(a) for a in W.fanout_input(name))
    return SlidingWindowInferer(W.fanout_model, W.FANOUT_ROI, k, 0.5, "gaussian",
                                out_channels=2, device="cpu")(x, mods)


def _jax_fanout_model(w, m):
    """`W.fanout_model` in jnp."""
    m = m.astype(w.dtype)[:, None, None, None, None]
    return jnp.concatenate([jnp.roll(w, 1, axis=1) * 2.0 + m, w + 1.0], -1)


@functools.lru_cache(maxsize=None)
def jax_fanout(name: str, world: int) -> np.ndarray:
    """A `W.FANOUT` case's logits through JAX's inferer with its windows
    fanned out over a CPU mesh of `world` devices (tests/test_inferer.py:157
    builds it over eight)."""
    _, k, _ = W.FANOUT[name]
    x, mods = W.fanout_input(name)
    jmesh = JMesh(np.array(jax.devices()[:world]), ("data",))
    inferer = JSlidingWindowInferer(_jax_fanout_model, roi_size=W.FANOUT_ROI, sw_batch_size=k,
                                    overlap=0.5, mode="gaussian", out_channels=2, mesh=jmesh)
    return np.asarray(inferer(jnp.asarray(x), jnp.asarray(mods)))


@functools.lru_cache(maxsize=None)
def evaluate_one_process() -> dict:
    """`W.evaluate`'s C-UNet evaluation in one process: metrics, windows."""
    trainer = engine.Trainer(Config(**W.MODELS["unet"]), device="cpu",
                             logger=MetricLogger(None, quiet=True))
    metrics = trainer.evaluate(W.eval_volumes(), trainer.init_state(start("unet")))
    return {"metrics": metrics, "windows": trainer.history["eval_windows"]}


# ------------------------------------------------------------ placements

@pytest.mark.parametrize("ndim,data_axis", [(5, "data"), (4, None), (1, "data"), (1, None),
                                            (3, "data"), (0, "data"), (2, None)])
def test_spatial_spec_is_jax(ndim, data_axis):
    assert spatial.spatial_spec(ndim, data_axis, "sp") == tuple(
        j_spatial_spec(ndim, data_axis, "sp"))


@pytest.mark.parametrize("mesh_shape,mesh_axes", [((2, 4), ("data", "sp")), ((8,), ("sp",)),
                                                  ((4, 2), ("data", "sp")), ((8,), ("data",))])
@pytest.mark.parametrize("key,shape", [("image", (2, 16, 8, 8, 1)), ("label", (2, 16, 8, 8)),
                                       ("modality", (2,)), ("odd", (3, 15, 8, 8, 1)),
                                       ("batch_of_one", (1, 16, 4, 4, 1))])
def test_shard_spatial_batch_is_jax(mesh_shape, mesh_axes, key, shape):
    """The placement of every array (JAX's spec, D = 15 and an indivisible
    batch staying whole) and each rank's piece: JAX's shard on the device
    at the same mesh coordinates."""
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(mesh_shape), mesh_axes)
    placed = j_shard_spatial_batch({key: x, "name": "vol1"}, jmesh)
    assert placed["name"] == "vol1"
    for coords in itertools.product(*(range(n) for n in mesh_shape)):
        mesh = parallel.Mesh(tuple(mesh_shape), tuple(mesh_axes), coords, {})
        assert spatial.placement(shape, mesh) == tuple(placed[key].sharding.spec)
        piece = spatial.shard_spatial_batch({key: x, "name": "vol1"}, mesh)
        assert piece["name"] == "vol1"
        device = jmesh.devices[coords]
        want = next(s.data for s in placed[key].addressable_shards if s.device == device)
        np.testing.assert_array_equal(piece[key], np.asarray(want))


# ----------------------------------------------------------------- pieces

FUNCTIONS = {  # name -> tolerance (f64 pieces; f32 kernels and group norm's f32 statistics)
    **{f"halo_d {lo} {hi}": 1e-12 for lo, hi in ((1, 1), (1, 0), (0, 1), (2, 1), (1, -1))},
    "gather_d": 1e-12, "slice_d": 1e-12, "gather_rows": 1e-12, "sum_over_line": 1e-10,
    "merge_moments": 1e-10, "K4 halo prologue=False": 2e-5, "K4 halo prologue=True": 2e-5,
    "K1 moments + merge": 1e-5, "group norm": 2e-5,
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_pieces_against_the_whole_volume(ranks, name):
    for r, res in enumerate(ranks["sp2"]):
        gap = res["functions"][name]
        assert gap <= FUNCTIONS[name], (name, r, gap)


@pytest.mark.parametrize("name", ["dice", "focal", "cross_entropy", "generalized_dice",
                                  "dice_focal", "dice_ce", "generalized_dice_focal"])
def test_losses_over_slabs(ranks, name):
    """The losses compute in f32: the sums over the line differ from the
    whole patch's by their order only."""
    for r, res in enumerate(ranks["sp2"]):
        assert res["losses"][name] <= 1e-6, (name, r, res["losses"][name])


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("pad_lo,pad_hi", list(itertools.product((False, True), repeat=2)))
def test_k4_halo_mode_each_flag_pair(pad_lo, pad_hi, prologue):
    """K4's halo mode (plain) on a slab of 4 planes cut from a volume with
    one real neighbour plane on each unflagged side (a flagged plane holds
    garbage, which the mode must read as zero): y and the moments equal the
    whole volume's conv on those planes; the autograd Function's gradients
    equal autograd through the plain version (f32)."""
    g = torch.Generator().manual_seed(7)
    dl, lo, hi = 4, int(not pad_lo), int(not pad_hi)
    volume = torch.randn((1, dl + lo + hi, 6, 5, 4), generator=g)
    garbage = 50 * torch.randn((1, 1, 6, 5, 4), generator=g)
    xh = torch.cat([garbage if pad_lo else volume[:, :1], volume[:, lo:lo + dl],
                    garbage if pad_hi else volume[:, -1:]], 1)
    w = torch.randn((3, 4, 3, 3, 3), generator=g) / 10
    kw = {}
    if prologue:
        kw = dict(scale=1 + 0.3 * torch.randn((1, 4), generator=g),
                  shift=0.3 * torch.randn((1, 4), generator=g), slope=0.01)
    y, mean, m2 = fused_conv.conv3_halo_moments_plain(xh, w, pad_lo=pad_lo, pad_hi=pad_hi, **kw)
    whole = fused_conv.conv3_norm_columns_plain(volume, w, **kw)[0][:, lo:lo + dl]
    np.testing.assert_allclose(y.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    rm, rq = fused_norm.channel_moments_plain(whole.reshape(1, -1, 3))
    np.testing.assert_allclose(mean.numpy(), rm.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m2.numpy(), rq.numpy(), rtol=1e-5, atol=1e-5)
    # the Function's backward against autograd through the plain version
    leaves = [xh, w, *((kw["scale"], kw["shift"]) if prologue else ())]
    dy = torch.randn(y.shape, generator=g)
    dmom = torch.randn((2, 1, 3), generator=g)
    grads = []
    for fn in (fused_conv.conv3_halo_moments, fused_conv.conv3_halo_moments_plain):
        ins = [t.clone().requires_grad_() for t in leaves]
        extra = dict(scale=ins[2], shift=ins[3], slope=0.01) if prologue else {}
        yy, mm, qq = fn(ins[0], ins[1], pad_lo=pad_lo, pad_hi=pad_hi, **extra)
        ((dy * yy).sum() + (dmom[0] * mm).sum() + (dmom[1] * qq).sum() / 100).backward()
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=2e-5)
    # the flagged planes take no gradient
    if pad_lo:
        assert not grads[0][0][:, 0].any()
    if pad_hi:
        assert not grads[0][0][:, -1].any()


def test_k1_moments_mode_and_its_backward():
    """K1's moments mode (plain) is the two-pass (mean, M2); its autograd
    Function's backward equals autograd through the plain version."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 300, 5), generator=g) * 2 + 1
    mean, m2 = fused_norm.channel_moments(x)
    np.testing.assert_allclose(mean.numpy(), x.mean(1).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m2.numpy(), (x.var(1, correction=0) * 300).numpy(), rtol=1e-5)
    da, db = torch.randn((2, 2, 5), generator=g)
    grads = []
    for fn in (fused_norm.channel_moments, fused_norm.channel_moments_plain):
        xi = x.clone().requires_grad_()
        m, q = fn(xi)
        ((da * m).sum() + (db * q).sum()).backward()
        grads.append(xi.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- steps

@pytest.mark.parametrize("case", ["unet_sp2", "unet_sp4", "unet_dp_sp"])
def test_unet_step_like_jax(ranks, case):
    """JAX's tiny C-UNet on the line (and with "data"): every rank's loss,
    parameters and applied gradients held to JAX's one-process SGD step on
    the global batch; the masters bitwise equal on every rank."""
    want = jax_step("unet")
    results = [res[case] for res in _results(ranks, case)]
    for r, got in enumerate(results):
        assert got["sp_top"] == (16, 16), got["sp_top"]   # the patch's D is partitioned
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["params"].keys() == want["params"].keys()
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{case} rank {r} {n}")
        gaps = {n: float((g - torch.as_tensor(want["grads"][n])).abs().max())
                for n, g in got["grads"].items()}
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
    assert len({got["digest"] for got in results}) == 1


def test_swin_forward_like_jax(ranks):
    """JAX's tiny swin forward, its input D cut over two ranks: the gathered
    logits on every rank within rtol 1e-4 / atol 1e-4 of JAX's (JAX's own
    SP test allows rtol 1e-3 / atol 5e-4)."""
    want = jax_swin_forward()
    for res in ranks["sp2"]:
        np.testing.assert_allclose(res["forward"].numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["swin_sp2", "swin_dropout_sp2", "unet_batch_sp2"])
def test_step_like_one_process(ranks, case):
    """The tiny swin's SGD step on the line, without and with dropout,
    attention dropout and drop-path, and the batch-norm C-UNet's (its
    statistics over the data x spatial ranks): every rank's loss within
    1e-5, every applied gradient leaf within 5e-5, the parameters within
    1e-6 and the running statistics within 1e-6 of the port's one process
    on the global batch (the same masks: each rank keeps its slab's or
    window rows' part of what one process draws); the masters bitwise
    equal on every rank."""
    want = one_process(case)
    results = [res[case] for res in ranks["sp2"]]
    for r, got in enumerate(results):
        assert got["sp_top"] == ((16, 16) if case.startswith("unet") else (32, 32))
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (case, r, got["loss"], want["loss"])
        gaps = {n: float((g - want["grads"][n]).abs().max()) for n, g in got["grads"].items()}
        assert gaps.keys() == want["grads"].keys()
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(), rtol=0, atol=1e-6)
        assert got["buffers"].keys() == want["buffers"].keys()
        for n, b in got["buffers"].items():
            np.testing.assert_allclose(b.numpy(), want["buffers"][n].numpy(), rtol=1e-5,
                                       atol=1e-6)
    assert len({got["digest"] for got in results}) == 1
    if case == "swin_dropout_sp2":   # the masks act: the loss differs from no dropout
        assert abs(want["loss"] - one_process("swin_sp2")["loss"]) > 1e-4


# ----------------------------------------------------- every model family

# the steps held to JAX too (JAX draws other dropout masks)
JAX_CASES = [c for c in W.MODEL_CASES if c != "unetr_dropout_sp2"]


def _top(case: str) -> tuple:
    """The patch's dims 1 and 2: the partition every rank of a case runs."""
    return Config(**W.MODELS[W.CASES[case][0]]).roi[:2]


def test_cases_reach_their_levels():
    """The level rule at the cases' shapes: the tiny C-UNETR's token level
    (D 4 at 64^3) is sharded on [2] and whole on [4]; the tiny UNetVanilla's
    2-plane level is whole on [2] and its 4-plane one on [4], each upsampled
    into a sharded level; the 2-D swin's stages are sharded down to its
    4-row level."""
    def sharded(roi, d, n):
        line = spatial.Line(None, n, 0, roi, roi)
        return spatial.sharded_depth(spatial.level_depth(line, d), n)

    assert sharded(64, 4, 2) and not sharded(64, 4, 4)
    assert not sharded(16, 2, 2) and sharded(16, 4, 2)
    assert not sharded(16, 4, 4) and sharded(16, 8, 4)
    assert all(sharded(32, d, 2) for d in (32, 16, 8, 4)) and not sharded(32, 2, 2)


@pytest.mark.parametrize("case", JAX_CASES)
def test_model_step_like_jax(ranks, case):
    """C-UNETR, UNetVanilla (and its batch-norm recipe) on the line and
    with "data", and the four families in 2-D: every rank's loss,
    parameters and applied gradients held to JAX's one-process SGD step
    on the global batch at the C-UNet's gates (loss rtol 1e-5, params rtol
    1e-4 / atol 1e-5, gradients within 5e-5 a leaf), the running
    statistics within 1e-5; the masters bitwise equal on every rank."""
    want = jax_step(W.CASES[case][0])
    results = [res[case] for res in _results(ranks, case)]
    for r, got in enumerate(results):
        assert got["sp_top"] == _top(case), got["sp_top"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["params"].keys() == want["params"].keys()
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{case} rank {r} {n}")
        gaps = {n: float((g - torch.as_tensor(want["grads"][n])).abs().max())
                for n, g in got["grads"].items()}
        assert gaps.keys() == want["grads"].keys()
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
        assert got["buffers"].keys() == want["buffers"].keys()
        for n, b in got["buffers"].items():
            np.testing.assert_allclose(b.numpy(), want["buffers"][n], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} rank {r} {n}")
    assert len({got["digest"] for got in results}) == 1
    # the gate bites: the gradients are not all near zero
    assert max(float(torch.as_tensor(g).abs().max()) for g in want["grads"].values()) \
        > 100 * ATOL_LEAF


@pytest.mark.parametrize("case", W.MODEL_CASES)
def test_model_step_like_one_process(ranks, case):
    """The same steps, and C-UNETR's with ViT dropout, under
    `test_step_like_one_process`'s gates: every rank's loss within 1e-5,
    every applied gradient leaf within 5e-5, the parameters within 1e-6
    and the running statistics within 1e-6 of the port's one process on
    the global batch; the masters bitwise equal on every rank."""
    want = one_process(case)
    results = [res[case] for res in _results(ranks, case)]
    for r, got in enumerate(results):
        assert got["sp_top"] == _top(case), got["sp_top"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (case, r, got["loss"], want["loss"])
        gaps = {n: float((g - want["grads"][n]).abs().max()) for n, g in got["grads"].items()}
        assert gaps.keys() == want["grads"].keys()
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{case} rank {r} {n}")
        assert got["buffers"].keys() == want["buffers"].keys()
        for n, b in got["buffers"].items():
            np.testing.assert_allclose(b.numpy(), want["buffers"][n].numpy(), rtol=1e-5,
                                       atol=1e-6)
    assert len({got["digest"] for got in results}) == 1
    if case == "unetr_dropout_sp2":   # the masks act: the ViT's gradients move past the gate
        plain = one_process("unetr_sp2")["grads"]
        assert max(float((g - plain[n]).abs().max()) for n, g in want["grads"].items()
                   if n.startswith("vit.")) > 10 * ATOL_LEAF


def test_swin_2d_forward_like_jax(ranks):
    """The tiny swin's 2-D twin forward, its input H cut over two ranks: the
    gathered logits on every rank within rtol 1e-4 / atol 1e-4 of JAX's."""
    want = jax_swin_forward("swin_2d")
    for res in ranks["sp2"]:
        assert res["forward_2d"].shape == want.shape
        np.testing.assert_allclose(res["forward_2d"].numpy(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ SP + FSDP

def _sp_fsdp_results(ranks, case: str) -> list:
    """A SP + FSDP case's results on every rank, each checked to have placed
    leaves on the case's FSDP axis and its patch partitioned (or whole)."""
    results = [res[case] for res in _results(ranks, case)]
    model, shape, _, extra = W.CASES[case]
    depth = W.MODELS[model]["roi_x"]
    for got in results:
        assert got["sp_top"] == (None if model == "unet_whole" else (depth, 16 if model ==
                                                                      "unet" else 32))
        axes = {axis for _, axis, _ in got["placed"].values()}
        assert axes == {extra["fsdp_axis"]}, got["placed"]
    return results


@pytest.mark.parametrize("case", W.FSDP_CASES)
def test_sp_fsdp_step_like_one_process(ranks, case):
    """Each SP + FSDP step under `test_step_like_one_process`'s gates: the
    loss within 1e-5, every applied gradient leaf (gathered whole) within
    5e-5, the parameters within 1e-6 of the port's one process; the
    gathered masters bitwise equal on every rank."""
    want = one_process(case)
    results = _sp_fsdp_results(ranks, case)
    for r, got in enumerate(results):
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (case, r, got["loss"], want["loss"])
        gaps = {n: float((g - want["grads"][n]).abs().max()) for n, g in got["grads"].items()}
        assert gaps.keys() == want["grads"].keys()
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{case} rank {r} {n}")
    assert len({got["digest"] for got in results}) == 1


@pytest.mark.parametrize("case", W.FSDP_CASES)
def test_sp_fsdp_step_like_jax(ranks, case):
    """Each SP + FSDP step under `test_unet_step_like_jax`'s gates, against
    JAX's one-process SGD step on the global batch: the loss within rtol
    1e-5, the parameters within rtol 1e-4 / atol 1e-5, every applied
    gradient leaf within 5e-5.  Half a gradient, or one counted twice,
    fails the last."""
    want = jax_step(W.CASES[case][0])
    for r, got in enumerate(_sp_fsdp_results(ranks, case)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["params"].keys() == want["params"].keys()
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{case} rank {r} {n}")
        gaps = {n: float((g - torch.as_tensor(want["grads"][n])).abs().max())
                for n, g in got["grads"].items()}
        assert max(gaps.values()) <= ATOL_LEAF, (case, r, max(gaps, key=gaps.get))
    # the gate bites: the sharded leaves' gradients are far above it
    placed = _sp_fsdp_results(ranks, case)[0]["placed"]
    assert sum(float(torch.as_tensor(want["grads"][n]).abs().max()) for n in placed) \
        > 100 * ATOL_LEAF


@pytest.mark.parametrize("case", W.FSDP_CASES)
def test_sp_fsdp_state_bytes(ranks, case):
    """A rank's bytes of f32 masters and momentum: one process's less the
    sharded leaves' share, (1 - 1/n) of each such leaf's master and
    momentum."""
    want = one_process(case)
    for r, got in enumerate(_sp_fsdp_results(ranks, case)):
        share = sum(want["params"][n].numel() * 4 * want["state_tensors"][n] * (size - 1)
                    // size for n, (_, _, size) in got["placed"].items())
        print(f"{case} rank {r}: {got['state_bytes']} bytes of masters and momentum against "
              f"one process's {want['state_bytes']}; {len(got['placed'])} leaves sharded")
        assert share > 0 and got["state_bytes"] == want["state_bytes"] - share


@pytest.mark.parametrize("case", W.FSDP_CASES)
def test_sp_fsdp_checkpoint_round_trip(ranks, case):
    """The step's checkpoint, gathered whole, restored into a fresh state
    and gathered again: the same bits on every rank; its parameters (the
    step's, gathered) within 1e-6 and its momentum within 5e-5 of one
    process's checkpoint."""
    want = one_process(case)
    for r, got in enumerate(_sp_fsdp_results(ranks, case)):
        trip = got["round_trip"]
        assert trip["params_equal"] and trip["moments_equal"], (case, r)
        assert trip["moments"].keys() == want["moments"].keys()
        for n, m in trip["moments"].items():
            np.testing.assert_allclose(m.numpy(), want["moments"][n].numpy(), rtol=0,
                                       atol=ATOL_LEAF, err_msg=f"{case} rank {r} {n}")


# ------------------------------------------------------ window fan-out

FANOUT_RUNS = [(suite, name) for suite in SUITE_WORLDS for name in W.FANOUT]


def _group_sizes(name: str) -> list[int]:
    """The windows of each group of a `W.FANOUT` case, in order."""
    spatial_, k, _ = W.FANOUT[name]
    n = len(window_starts(spatial_, W.FANOUT_ROI, 0.5)[1])
    return [min(k, n - g) for g in range(0, n, k)]


def _groups(name: str) -> int:
    return len(_group_sizes(name))


def test_fanout_cases_leave_ranks_idle():
    """The cases reach what the fan-out must handle: group counts neither
    world divides (on four ranks two predict only padded repeats), and a
    short last group."""
    assert [_groups(n) for n in W.FANOUT] == [6, 2, 3]
    assert any(g % 4 and g < 4 for g in map(_groups, W.FANOUT))
    assert any(g % 2 for g in map(_groups, W.FANOUT))


@pytest.mark.parametrize("suite,name", FANOUT_RUNS)
def test_window_fanout_like_one_process(ranks, suite, name):
    """Every rank's fanned-out logits within 1e-6 of one process's (they are
    its bits: the same groups, added in the same order)."""
    want = fanout_one_process(name)
    for r, res in enumerate(ranks[suite]):
        got = res["fanout"][name, False]["logits"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(got, want), (suite, name, r)


@pytest.mark.parametrize("suite,name", FANOUT_RUNS)
def test_window_fanout_like_jax(ranks, suite, name):
    """Every rank's fanned-out logits within 1e-4 of JAX's fan-out inferer
    over as many CPU devices (the gate of tests/test_inferer.py:157)."""
    want = jax_fanout(name, SUITE_WORLDS[suite])
    for res in ranks[suite]:
        np.testing.assert_allclose(res["fanout"][name, False]["logits"].numpy(), want,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("suite,name", FANOUT_RUNS)
def test_window_fanout_predict_calls(ranks, suite, name):
    """A rank predicts ⌈G/N⌉ groups, padded repeats included, and
    `windows_predicted` counts their windows; under `stitch_on_host`
    every rank predicts every group (no fan-out), its logits one
    process's."""
    world, sizes = SUITE_WORLDS[suite], _group_sizes(name)
    groups = len(sizes)
    ids = list(range(groups)) + [groups - 1] * (-groups % world)
    for r, res in enumerate(ranks[suite]):
        fanned, host = res["fanout"][name, False], res["fanout"][name, True]
        assert fanned["calls"] == math.ceil(groups / world), (suite, name, r, fanned["calls"])
        assert fanned["windows"] == sum(sizes[g] for g in ids[r::world])
        assert host["calls"] == groups and host["windows"] == sum(sizes)
        np.testing.assert_allclose(host["logits"].numpy(), fanout_one_process(name).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("suite", sorted(SUITE_WORLDS))
def test_evaluate_like_one_process(ranks, suite):
    """`Trainer.evaluate` on `[2]` (the "sp" line, fan-out over it) and
    `[2, 2]` ("data" x "sp": fan-out over "data", the "sp" ranks repeat
    it): every rank's metrics one process's (Dice equal, losses within
    1e-6), and a rank's windows ⌈G/N⌉ of each volume's G (3 and 6, N = 2)."""
    want = evaluate_one_process()
    assert want["windows"] == [3, 6]
    for r, res in enumerate(ranks[suite]):
        got = res["evaluate"]
        assert got["windows"] == [2, 3], (suite, r, got["windows"])
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, v in got["metrics"].items():
            if "dice" in key or "accuracy" in key:
                assert v == want["metrics"][key] or (np.isnan(v) and np.isnan(
                    want["metrics"][key])), (suite, r, key)
            else:
                assert abs(v - want["metrics"][key]) <= 1e-6, (suite, r, key)


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("model", ["unet", "unetr", "swin", "unet_2d", "unetr_2d", "swin_2d"])
def test_no_transposed_conv_leaves_a_slab_short(model):
    """Every transposed conv of a model (C-UNet's k3 s2 p1 up-convs,
    UNETR's and the swin's k2 s2 up-blocks) computes a whole output slab
    from the halo `conv_transpose` reads (`spatial.conv_dims`), at every
    slab size a sharded level has, so its short-slab ValueError is never
    reached (UNetVanilla upsamples without one)."""
    net = _build(Config(**W.MODELS[model]), torch.device("meta"), torch.float32, True)
    convs = [m for m in net.modules() if getattr(m, "is_transposed", False)]
    assert convs
    for m in convs:
        k, s, p = m.kernel_size[0], m.strides[0], m.padding[0]
        lo, hi = spatial.conv_dims(k, s, p, transposed=True)
        for d in (2, 4, 8, 24):
            y = torch.nn.functional.conv_transpose1d(torch.zeros(1, 1, lo + d + hi),
                                                     torch.zeros(1, 1, k), stride=s, padding=p)
            assert y.shape[-1] >= s * (lo + d), (model, k, s, p, d)


@pytest.mark.parametrize("name", ["fsdp_with_tp", "tensor_parallel", "pipeline_parallel",
                                  "unetr", "unet_vanilla", "2d", "axis_without_flag",
                                  "flag_on_data"])
def test_out_of_scope_raises(ranks, name):
    """No configuration SP once refused raises now: SP beside tensor
    parallelism (with FSDP on the line too) and beside the pipeline flag
    (no pipeline line), C-UNETR, UNetVanilla and 2-D build on the line and
    step as one process does (loss within 1e-5, every gradient leaf within
    5e-5, from the port's own init); the spatial axis without
    `spatial_shard` builds, and its step raises JAX's `shard_batch`
    KeyError (no "data" axis, no spatial line); the field alone is
    taken."""
    for res in ranks["sp2"]:
        said = res["refusals"]["said"][name]
        if name in W.STEPPED:
            assert said is None, said
            got, want = res["refusals"]["stepped"][name], refusal_one_process(name)
            assert got["sp_top"] == (16, 16), got["sp_top"]
            assert abs(got["loss"] - want["loss"]) <= 1e-5, (name, got["loss"], want["loss"])
            gaps = {n: float((g - want["grads"][n]).abs().max())
                    for n, g in got["grads"].items()}
            assert gaps.keys() == want["grads"].keys()
            assert max(gaps.values()) <= ATOL_LEAF, (name, max(gaps, key=gaps.get))
            continue
        if name == "flag_on_data":   # no spatial line of more than one rank: the field is taken
            assert said is None
            continue
        assert said == "KeyError: 'data'", said
