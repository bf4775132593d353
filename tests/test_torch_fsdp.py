"""FSDP in the port (`miseg_tpu_torch.parallel.fsdp`, the mesh of
`parallel.mesh`) on the CPU: gloo ranks as subprocesses
(`tests/_torch_mesh_worker.py`), spawned once for the module, two for the
1-D mesh `[2]` and four for the hybrid `[2, 2]` ("data", "model") with
`fsdp_axis="model"`, each held to a timeout, against one process on the
global batch and against the JAX package.

* Placements, with no spawn: the port shards exactly the leaves JAX's
  `leaf_spec` / `tree_shardings` shard, on the counterpart dims of the
  bridge's layouts (`weights.flax_dims`), on the cases of
  tests/test_fsdp.py:21-42, JAX's tiny UNet, UNETR and swin trees and the
  flagship's (fs 48) shapes.
* Steps: JAX's tiny UNet (tests/test_fsdp.py:44-51) two AdamW steps
  under FSDP `[2]`, two micro-steps of one accumulation window under it,
  and the hybrid `[2, 2]`: every rank's gathered gradients of the first
  update within 5e-5 a leaf and 1e-3 summed, the parameters within the
  W5 bound, the losses within 1e-5 of the port's one process on the
  global batch and of JAX's `value_and_grad` + optax step on it (bridged
  from the same seeded weights; the W5 bound a update there).
* Memory: each rank's bytes of f32 masters plus AdamW moments are the
  replicated leaves' plus 1/n of the others', and more than half the
  elements are sharded (tests/test_fsdp.py:55-79's claim).
* Evaluation: the sliding-window inferer under FSDP equals data
  parallelism (tests/test_fsdp.py:167-188).
* Checkpoints: what two FSDP ranks write resumes in one process, and one
  process's checkpoint resumes under FSDP, with equal parameters, AdamW
  moments and step, and its next step held to one process's.
* The mesh: JAX's `make_mesh` rules and errors, the row-major
  coordinates, any axis name taken, and the pipeline and spatial modes
  without a line of more than one rank taking the data-parallel step
  (JAX's rule).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_bridge import seeded_params

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.parallel import leaf_spec as j_leaf_spec
from miseg_tpu.parallel import tree_shardings
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch import parallel
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.models.factory import _build
from miseg_tpu_torch.parallel import fsdp
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from miseg_tpu_torch.weights import _convert, flax_dims, state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
ATOL_LEAF, ATOL_LEAF_SUM = 5e-5, 1e-3
ATOL_LOSS = 1e-5
FLAGSHIP = dict(model_name="swin_unetr", out_channels=6, feature_size=[48], num_heads=3,
                depth_swin_block=[2], roi_x=96, roi_y=96, roi_z=96,
                encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                decoder_norm_name="instance")
SUITE_WORLDS = {"fsdp2": 2, "fsdp4": 4}


# ---------------------------------------------------------------- shared

@functools.lru_cache(maxsize=None)
def jax_model(model: str):
    """(JAX module, seeded params) of one of `W.MODELS`."""
    cfg = W.MODELS[model]
    batch = W.global_batches(cfg)[0]
    jmodel = jax_model_from_config(JConfig(**cfg))
    return jmodel, seeded_params(jmodel, jnp.asarray(batch["image"]),
                                 jnp.asarray(batch["modality"]))


def start(model: str) -> dict:
    """The port's start of a model: JAX's seeded params, bridged."""
    return state_dict_from_jax(jax_model(model)[1])


@functools.lru_cache(maxsize=None)
def jax_steps(name: str) -> dict:
    """JAX's steps of a case on each whole global batch (what a JAX run on
    any mesh computes), from `start`: the record of `W.run_steps`."""
    cfg = W.case_config(name, one_process=True)
    jcfg = JConfig(**cfg)
    jmodel, params = jax_model(W.CASES[name][0])
    loss_fn = JL.loss_from_config(jcfg)

    def loss_of(p, image, label, mods):
        return loss_fn(jmodel.apply({"params": p}, image, mods, train=True)
                       .astype(jnp.float32), label)

    grad_fn = jax.jit(jax.value_and_grad(loss_of))
    tx = j_optimizer_from_config(jcfg)
    update = jax.jit(tx.update)
    opt = tx.init(params)
    losses, window, params_step1 = [], [], None
    for batch in W.global_batches(cfg):
        loss, grads = grad_fn(params, batch["image"], batch["label"][..., 0],
                              batch["modality"])
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        window.append(grads)
        params_step1 = params if params_step1 is None else params_step1
    k = cfg.get("iters_to_accumulate", 1)
    applied = jax.tree.map(lambda *g: np.mean(np.stack(g), 0), *window[:k])
    tree = functools.partial(jax.tree.map, np.array)
    return {"params": state_dict_from_jax(tree(params)),
            "params_step1": state_dict_from_jax(tree(params_step1)),
            "grads": state_dict_from_jax(tree(applied)), "buffers": {},
            "losses": losses, "optimizer_steps": W.STEPS // k}


@functools.lru_cache(maxsize=None)
def one_process(name: str) -> dict:
    """The port's one process on each whole global batch."""
    return W.run_steps(W.case_config(name, one_process=True), start(W.CASES[name][0]),
                       W.case_batches(name))


def copies_held(results: list, case: str) -> None:
    """The gradient rule on gradients that differ by rank
    (`W.copies_reduced`): each leaf's reduced gradient is
    `W.reduced_factor` times its draw on every rank, and each replicated
    leaf's the same bits on every rank."""
    for r, res in enumerate(results):
        got, placed = res["copies"][case], res[case]["placements"]
        for n, drawn in got["drawn"].items():
            factor = W.reduced_factor(case, r, placed[n][2] if n in placed else None)
            torch.testing.assert_close(got["reduced"][n].double(), drawn.double() * factor,
                                       rtol=1e-6, atol=1e-6, msg=f"{case} rank {r} {n}")
    for n, v in results[0]["copies"][case]["reduced"].items():
        if n not in results[0][case]["placements"]:
            assert all(torch.equal(v, res["copies"][case]["reduced"][n])
                       for res in results[1:]), (case, n)


def held(got: dict, want: dict, what: str, per_update: bool = False) -> None:
    """`got` (a `W.run_steps` record) against `want`: the losses within
    1e-5, every gradient leaf of the first update within 5e-5 and their
    sum within 1e-3, the parameters within the W5 step bound (rtol 1e-4 /
    atol 2.5e-4 at lr 1e-4: an element whose true gradient is 0 moves by
    lr x the sign of its rounding noise at every Adam update), after the
    first update and, with `per_update`, within it times the updates after
    the last (two programs that round differently: JAX and the port).
    The gradients are the first update's, taken at equal parameters: the
    W5 moves of the first update change the next gradients by more than
    the gate on the tiny UNETR (its 8 tokens a volume), one process
    against JAX as much as ranks against one process."""
    assert got["optimizer_steps"] == want["optimizer_steps"] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=ATOL_LOSS)
    gaps = {n: float((g - want["grads"][n]).abs().max()) for n, g in got["grads"].items()}
    assert gaps.keys() == want["grads"].keys()
    worst = max(gaps, key=gaps.get)
    print(f"{what}: gradient gap summed over {len(gaps)} leaves "
          f"{sum(gaps.values()):.3e}, worst {worst} {gaps[worst]:.2e}; losses "
          f"{got['losses']} vs {want['losses']}")
    assert sum(gaps.values()) <= ATOL_LEAF_SUM and gaps[worst] <= ATOL_LEAF
    # the gate bites: half the batch's gradient alone would not pass it
    assert sum(float(g.abs().max()) for g in want["grads"].values()) > 10 * ATOL_LEAF_SUM
    bounds = ((("params_step1", ATOL_STEP), ("params", ATOL_STEP * want["optimizer_steps"]))
              if per_update else (("params_step1", ATOL_STEP), ("params", ATOL_STEP)))
    for key, atol in bounds:
        assert got[key].keys() == want[key].keys()
        for n, p in got[key].items():
            np.testing.assert_allclose(p.numpy(), want[key][n].numpy(), rtol=RTOL_STEP,
                                       atol=atol, err_msg=f"{what} {key} {n}")


def spawn(suite: str, world: int, tmp: Path) -> list:
    """`world` ranks of `suite` (`W.main`), started; join with `joined`."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"), suite, str(r),
         str(world), str(tmp / f"{suite}.rdzv"), str(tmp), str(tmp / "starts.pt")], env=env,
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def joined(procs: dict, tmp: Path) -> dict:
    """Every suite's ranks' results, each rank held to `RANK_TIMEOUT_S`;
    any that fails or hangs fails the test."""
    logs = {}
    try:
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


def port_dims(params: dict, specs: dict, axis: str) -> dict:
    """JAX's placements (a tree of `PartitionSpec`s over `params`) as the
    port's: `{port name: dim}` of the leaves split over `axis`."""
    out = {}
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat_p, flat_s):
        names = tuple(str(getattr(k, "key", k)) for k in path)
        name, _ = _convert(names, torch.empty(tuple(leaf.shape), device="meta"))
        dims = [d for d, a in enumerate(tuple(spec)) if a == axis]
        if dims:
            out[name] = flax_dims(name, len(leaf.shape)).index(dims[0])
    return out


def jax_tree(model_cfg: dict):
    """JAX's param tree of a configuration, as shapes (`jax.eval_shape`)."""
    jmodel = jax_model_from_config(JConfig(**model_cfg))
    roi = (1, model_cfg["roi_x"], model_cfg["roi_y"], model_cfg["roi_z"], 1)
    return jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros(roi),
                          jnp.zeros((1,), jnp.int32))["params"]


def port_shapes(model_cfg: dict) -> dict:
    """The port's parameter shapes of a configuration (built on the meta
    device)."""
    model = _build(Config(**model_cfg), torch.device("meta"), torch.float32, True)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def placed(model_cfg: dict, mesh_shape, mesh_axes, **par) -> dict:
    """`fsdp.placements` of rank 0 of a mesh (no process group needed) for
    a configuration: `{name: dim}`."""
    cfg = Config(**model_cfg, **par, mesh_shape=list(mesh_shape), mesh_axes=list(mesh_axes))
    mesh = parallel.Mesh(tuple(mesh_shape), tuple(mesh_axes), (0,) * len(mesh_shape), {})
    return {n: pl.dim for n, pl in fsdp.placements(port_shapes(dict(model_cfg)), mesh,
                                                   cfg).items()}


def jax_mesh(shape, axes):
    return JMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both suites' ranks' results; JAX's steps and the one process are
    computed while the ranks run.  `one.ckpt`: the one process's state
    after one step, for the ranks to resume."""
    tmp = tmp_path_factory.mktemp("fsdp")
    torch.save({"unet": start("unet")}, tmp / "starts.pt")
    cfg = W.MODELS["unet"]
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.init_state(start("unet"))
    state, _ = trainer.train_step(state, W.global_batches(cfg, 1, seed=3)[0])
    save_checkpoint(tmp / "one.ckpt", params=trainer.state_dict(state),
                    opt_state=trainer.opt_state(state), epoch=0)
    procs = {suite: spawn(suite, world, tmp) for suite, world in SUITE_WORLDS.items()}
    try:
        for name in ("fsdp", "fsdp_accumulate", "hybrid"):
            jax_steps(name)
            one_process(name)
    finally:
        out = joined(procs, tmp)
    out["tmp"] = tmp
    return out


def _rank_results(ranks, case):
    suite = "fsdp4" if case == "hybrid" else "fsdp2"
    return ranks[suite]


# ------------------------------------------------------------ placements

@pytest.mark.parametrize("shape,n,min_size", [
    ((3, 3, 3, 16, 48), 8, 8192), ((16, 16), 8, 1), ((7, 9, 11, 13), 8, 1), ((2, 48), 8, 8192),
    ((), 8, 8192), ((64, 64), 1, 8192), ((128, 128), 8, 8192), ((4, 4), 8, 8192),
    ((3, 3, 3, 48, 48), 2, 8192), ((96, 32), 3, 1)])
def test_leaf_spec_is_jax(shape, n, min_size):
    """tests/test_fsdp.py:21-42's cases (and a few more): the same dim."""
    spec = tuple(j_leaf_spec(shape, n, "data", min_size))
    want = spec.index("data") if "data" in spec else None
    assert fsdp.leaf_spec(shape, n, min_size) == want


@pytest.mark.parametrize("model", ["unet", "unetr", "swin", "flagship"])
@pytest.mark.parametrize("n,min_size", [(2, 128), (4, 8192)])
def test_placements_are_jax(model, n, min_size):
    """The port's FSDP leaves and dims are JAX's `tree_shardings` on the
    same tree, mapped through the bridge's layouts."""
    model_cfg = FLAGSHIP if model == "flagship" else W.MODELS[model]
    tree = jax_tree(model_cfg)
    specs = jax.tree.map(lambda s: s.spec, tree_shardings(
        tree, jax_mesh((n,), ("data",)), "data", min_size))
    want = port_dims(tree, specs, "data")
    got = placed(model_cfg, (n,), ("data",), fsdp=True, fsdp_min_size=min_size)
    assert got == want and len(got) > 0
    # the 1-D "data" mesh and the hybrid's "model" axis place alike
    assert placed(model_cfg, (1, n), ("data", "model"), fsdp=True, fsdp_axis="model",
                  fsdp_min_size=min_size) == want
    # FSDP off, or its axis of size 1, places nothing (JAX's rule)
    assert placed(model_cfg, (n,), ("data",), fsdp_min_size=min_size) == {}
    assert placed(model_cfg, (n, 1), ("data", "model"), fsdp=True, fsdp_axis="model") == {}


# ----------------------------------------------------------------- steps

@pytest.mark.parametrize("case", ["fsdp", "fsdp_accumulate", "hybrid"])
def test_fsdp_steps_like_one_process(ranks, case):
    want = one_process(case)
    results = _rank_results(ranks, case)
    for r, res in enumerate(results):
        got = res[case]
        assert got["placements"] and all(k == "fsdp" for k, *_ in got["placements"].values())
        held(got, want, f"{case} rank {r}")
    # every rank gathers the same parameters
    for key in ("params", "grads"):
        for n, v in results[0][case][key].items():
            assert all(torch.equal(v, res[case][key][n]) for res in results[1:]), (key, n)
    if case == "fsdp_accumulate":
        assert want["optimizer_steps"] == 1     # two micro-steps, one window


@pytest.mark.parametrize("who", ["one_process", "rank0", "rank1"])
@pytest.mark.parametrize("case", ["fsdp", "fsdp_accumulate", "hybrid"])
def test_fsdp_steps_like_jax_on_the_global_batch(ranks, case, who):
    want = jax_steps(case)
    got = one_process(case) if who == "one_process" else \
        _rank_results(ranks, case)[int(who[-1])][case]
    held(got, want, f"{case} {who} vs JAX", per_update=True)


@pytest.mark.parametrize("case", ["fsdp", "hybrid"])
def test_fsdp_memory_share(ranks, case):
    """Masters + AdamW moments a rank: the replicated leaves' and 1/n of
    the sharded ones', n = 2 (the "data" axis, or the hybrid's "model")."""
    for r, res in enumerate(_rank_results(ranks, case)):
        got = res[case]
        sharded = got["whole_bytes"] - got["replicated_bytes"]
        print(f"{case} rank {r}: {got['state_bytes']} bytes of masters and moments of "
              f"{got['whole_bytes']} whole, {got['replicated_bytes']} replicated; "
              f"{got['placed_elements']} of {got['elements']} elements sharded")
        assert got["state_bytes"] <= got["replicated_bytes"] + sharded / 2
        assert got["state_bytes"] < 0.55 * got["whole_bytes"]
        assert got["placed_elements"] > 0.5 * got["elements"]


def test_fsdp_eval_matches_data_parallel(ranks):
    """tests/test_fsdp.py:167-188: the sliding-window inferer on gathered
    weights is the replicated one's."""
    for res in ranks["fsdp2"]:
        fs, dp = res["eval"]["fsdp"], res["eval"]["dp"]
        assert fs.shape == (1, W.EVAL_SIZE, W.EVAL_SIZE, W.EVAL_SIZE, 2)
        np.testing.assert_allclose(fs.numpy(), dp.numpy(), rtol=2e-5, atol=1e-5)
        assert torch.equal(fs, dp)


# ------------------------------------------------------ a repeat init

def held_repeat_init(results: list, start_sd: dict) -> None:
    """`W.repeat_init` on every rank of a suite: a repeat `init_state`
    gives the current parameters, whole (the start, then the step's, as
    one process's does), and what is gathered to rank 0 alone is there
    what every rank gathers, and None on the other ranks."""
    for r, res in enumerate(results):
        got = res["repeat_init"]
        for n, t in start_sd.items():
            assert torch.equal(got["again"][n], t), f"rank {r} {n}"
        assert got["after_step"].keys() == got["stepped"].keys()
        for n, t in got["stepped"].items():
            assert torch.equal(got["after_step"][n], t), f"rank {r} {n}"
        assert any(not torch.equal(got["stepped"][n], t) for n, t in start_sd.items())
        if r == 0:
            assert got["to_writer"].keys() == got["stepped"].keys()
            for n, t in got["stepped"].items():
                assert torch.equal(got["to_writer"][n], t), n
            _moments_equal(got["moments_to_writer"], got["stepped_moments"])
        else:
            assert got["to_writer"] is None and got["moments_to_writer"] is None


@pytest.mark.parametrize("suite", list(SUITE_WORLDS))
def test_repeat_init_state_keeps_parameters(ranks, suite):
    """Under FSDP (on "data" at `[2]`, on "model" at `[2, 2]`, where the
    second "model" line gathers nothing to rank 0) a second `init_state`
    without parameters starts from the current ones."""
    held_repeat_init(ranks[suite], start(W.CASES[W.REPEAT_INIT[suite]][0]))


# ----------------------------------------------------------- checkpoints

def _moments_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for n, st in got.items():
        assert st.keys() == want[n].keys()
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(want[n][k])), (n, k)


def test_fsdp_checkpoint_resumes_in_one_process(ranks):
    ck = load_checkpoint(ranks["tmp"] / "fsdp.ckpt")
    trainer = engine.Trainer(Config(**W.MODELS["unet"]), device="cpu")
    state = trainer.restore(trainer.init_state(start("unet")), ck)
    written = ranks["fsdp2"][0]["checkpoints"]["written"]
    # gathered to rank 0 alone
    assert [(res["checkpoints"]["written"]["params"] is not None,
             res["checkpoints"]["written"]["opt_state"]) for res in ranks["fsdp2"]] == [
        (True, True), (False, False)]
    assert state.step == written["step"] == W.STEPS
    for n, p in trainer.state_dict(state).items():
        assert torch.equal(p, written["params"][n]), n
    _moments_equal(W.moments(trainer, state), written["moments"])
    for res in ranks["fsdp2"][1:]:
        _moments_equal(res["checkpoints"]["written"]["moments"], written["moments"])


def test_one_process_checkpoint_resumes_under_fsdp(ranks):
    ck = load_checkpoint(ranks["tmp"] / "one.ckpt")
    trainer = engine.Trainer(Config(**W.MODELS["unet"]), device="cpu")
    state = trainer.restore(trainer.init_state(start("unet")), ck)
    want_moments = W.moments(trainer, state)
    batches = W.global_batches(W.MODELS["unet"], 1, seed=7)
    want_next = W.run_steps(W.MODELS["unet"], None, batches, trainer, state)
    for r, res in enumerate(ranks["fsdp2"]):
        got = res["checkpoints"]
        assert got["resumed"]["step"] == 1
        for n, p in got["resumed"]["params"].items():
            assert torch.equal(p, ck["params"][n]), n
        _moments_equal(got["resumed"]["moments"], want_moments)
        assert got["next"]["step"] == want_next["step"] == 2
        np.testing.assert_allclose(got["next"]["losses"], want_next["losses"], atol=ATOL_LOSS)
        for n, p in got["next"]["params"].items():
            np.testing.assert_allclose(p.numpy(), want_next["params"][n].numpy(),
                                       rtol=RTOL_STEP, atol=ATOL_STEP, err_msg=f"rank {r} {n}")


# ------------------------------------------------------------------ mesh

def test_mesh_coordinates_are_row_major(ranks):
    """Rank r's coordinates are `unravel_index(r, shape)`, as JAX reshapes
    its devices: the ranks of one "model" line are adjacent and share a
    "data" coordinate, which is the loader's shard."""
    assert [res["host_shard_info"] for res in ranks["fsdp4"]] == [(0, 2), (0, 2), (1, 2),
                                                                   (1, 2)]
    assert [res["host_shard_info"] for res in ranks["fsdp2"]] == [(0, 2), (1, 2)]


def test_mesh_rules_and_unported_modes():
    """At one process: JAX's `make_mesh` rules (-1 inferred, a product
    other than the world a ValueError, a size a name), any axis name (a
    spatial axis without `spatial_shard`: an axis of copies), and the
    pipeline and spatial modes, their lines of one rank, building and
    stepping as data parallelism does (JAX's `_pp_active` and SP rule; on
    lines of more than one rank: `tests/test_torch_ddp.py`,
    `tests/test_torch_spatial.py`, `tests/test_torch_pipeline.py`)."""
    assert parallel.make_mesh([-1], ["data"]).shape == (1,)
    assert parallel.make_mesh([1, -1], ["data", "model"]).shape == (1, 1)
    mesh = parallel.make_mesh([1, 1], ["data", "model"])
    assert (mesh.size("model"), mesh.index("model"), mesh.group("model")) == (1, 0, None)
    assert mesh.size("pp") == 1 and parallel.host_shard_info() == (0, 1)
    for shape, axes in (([2], ["data"]), ([2, -1], ["data", "model"]), ([-1], ["data", "model"]),
                        ([1, 1], ["data", "data"])):
        with pytest.raises(ValueError, match="mesh"):
            parallel.make_mesh(shape, axes)
    base = dict(W.MODELS["unet"])
    batch = W.global_batches(base, 1)[0]
    plain = engine.Trainer(Config(**base), device="cpu")
    _, want = plain.train_step(plain.init_state(start("unet")), batch)
    for kw in ({"mesh_axes": ["data", "pp"], "mesh_shape": [1, 1]}, {"mesh_axes": ["sp"]},
               {"pipeline_parallel": True}, {"spatial_shard": True},
               {"spatial_shard": True, "mesh_axes": ["sp"], "fsdp": True},
               {"mesh_axes": ["data", "pp"], "mesh_shape": [1, 1], "pipeline_parallel": True}):
        trainer = engine.Trainer(Config(**base, **kw), device="cpu")
        assert not trainer._pp_active()
        _, loss = trainer.train_step(trainer.init_state(start("unet")), batch)
        assert torch.equal(loss, want), kw
    # FSDP and tensor parallelism build; with their axes of size 1 they place nothing
    for kw in ({"fsdp": True}, {"tensor_parallel": True, "mesh_shape": [1, 1],
                                "mesh_axes": ["data", "model"]}):
        trainer = engine.Trainer(Config(**base, **kw), device="cpu")
        trainer.init_state()
        assert trainer.placements == {}
