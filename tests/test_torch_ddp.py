"""Data parallelism in the port (`miseg_tpu_torch.parallel`) on the CPU:
two gloo ranks, each a subprocess (`tests/_torch_ddp_worker.py`, one
spawn for every check below, rendezvous through a file under the test's
tmp_path, each rank held to a timeout so a hung rank fails the test),
against one process on the concatenated batch and against the JAX
package.

* Under JAX's multi-host semantics a step of N processes is the one
  process's step on their concatenated (global) batch.  So the two ranks,
  and the port's one process on the global batch, are held to JAX's
  `value_and_grad` and optax update on that batch, from the same seeded
  weights and running statistics (bridged by `state_dict_from_jax`): two
  AdamW steps of a batch-norm UNetVanilla, and two micro-steps of it under
  `iters_to_accumulate` = 2 (`optax.MultiSteps`, one update of the
  window's mean).  The gradients of the last update within 5e-5 a leaf
  and 1e-3 summed (the 3-D step tests' gate), the parameters within the
  W5 step bound (rtol 1e-4 / atol 2.5e-4, at lr 1e-4) after the first
  update and within it times the updates after the last (`_held`), the running
  statistics after the first step within 1e-6 (rtol 1e-5) and after the
  second within (1 - momentum) x the step bound (a conv bias before a
  batch norm gets a near-zero gradient, which Adam turns into a ~lr step,
  W5, and which shifts the next batch mean), the logged losses (averaged
  over the ranks) within 1e-5.  The batch-norm model holds only if the
  statistics' cross-rank merge and its backward (`parallel.batch_stats`)
  are right.
* The same gates, with W5 itself after two updates, between the two
  ranks and the port's one process, for
  those two cases and for the fs-12 C-Swin-UNETR with dropout and
  drop-path on; both ranks hold the same gradients and parameters.  The
  dropout case is held to one process of the port, not to JAX: JAX draws
  its masks from threefry keys and the port from a torch generator, so
  no mask of one is a mask of the other.  What the case shows is the
  port's own contract, that each rank keeps its slice of the mask one
  process draws over the global batch (`nn/dropout.py`).
* The train loader's shards are JAX's `DataLoader(shard, num_shards)`
  indices (numpy, no spawn).
* The trial broadcast: rank 1's trials received rank 0's suggestions,
  every number through float32 as JAX's `_bcast` sends it; rank 0 alone
  holds the study.
* Exactly one checkpoint writer in `cli.train`'s fit; the ranks end on
  the same parameters.
* The mesh at world 2 (in the worker) and at world 1 (here): FSDP and
  tensor parallelism build, the pipeline mode builds and, with no
  pipeline line of more than one rank, takes the data-parallel step,
  spatial partitioning builds beside FSDP on its line and beside tensor
  parallelism, any axis name is taken, and a mesh whose product is not
  the world size raises ValueError.
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bridge import seeded_params

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.data import dataset as JD
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data import dataset as D
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.nn.norms import MOMENTUM
from miseg_tpu_torch.parallel import host_shard_info, mesh_from_config
from miseg_tpu_torch.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ddp_worker as W  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
RANK_TIMEOUT_S = 300
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
ATOL_LEAF, ATOL_LEAF_SUM = 5e-5, 1e-3
ATOL_STATS = 1e-6
ATOL_LOSS = 1e-5
JAX_CASES = ("unet_vanilla_batch", "accumulate")


def _case(name: str) -> dict:
    return W.ACCUM_CASE if name == "accumulate" else W.STEP_CASES[name]


@functools.lru_cache(maxsize=None)
def _jax_start(name: str):
    """JAX's seeded parameters and running statistics (uniform in [0.5,
    1.5]) of a case, as trees."""
    cfg = _case(name)
    batch = W.global_batches(cfg)[0]
    jmodel = jax_model_from_config(JConfig(**cfg))
    args = (jnp.asarray(batch["image"]), jnp.asarray(batch["modality"]))
    params = seeded_params(jmodel, *args)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)["batch_stats"]
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)
    return params, stats


def _start(name: str) -> dict | None:
    """The port's start of a case: JAX's, bridged; None for the cases held
    to the port alone."""
    return state_dict_from_jax(*_jax_start(name)) if name in JAX_CASES else None


@functools.lru_cache(maxsize=None)
def _jax_steps(name: str) -> dict:
    """JAX's `W.run_steps` of a case: its step, on each whole global batch
    (what a JAX run of N processes computes), from `_jax_start`."""
    cfg = _case(name)
    jcfg = JConfig(**cfg)
    jmodel = jax_model_from_config(jcfg)
    params, stats = _jax_start(name)
    loss_fn = JL.loss_from_config(jcfg)

    def loss_of(p, s, image, label, mods):
        logits, new = jmodel.apply({"params": p, "batch_stats": s}, image, mods, train=True,
                                   mutable=["batch_stats"])
        return loss_fn(logits.astype(jnp.float32), label), new["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    tx = j_optimizer_from_config(jcfg)
    update = jax.jit(tx.update)
    opt = tx.init(params)
    losses, window, stats_step1, params_step1 = [], [], None, None
    for batch in W.global_batches(cfg):
        (loss, stats), grads = grad_fn(params, stats, batch["image"], batch["label"][..., 0],
                                       batch["modality"])
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        window.append(grads)
        stats_step1 = stats if stats_step1 is None else stats_step1
        params_step1 = params if params_step1 is None else params_step1
    k = cfg.get("iters_to_accumulate", 1)
    applied = jax.tree.map(lambda *g: np.mean(np.stack(g), 0), *window[-k:])
    tree = functools.partial(jax.tree.map, np.array)
    return {"params": state_dict_from_jax(tree(params)),
            "params_step1": state_dict_from_jax(tree(params_step1)),
            "buffers": state_dict_from_jax({}, tree(stats)),
            "buffers_step1": state_dict_from_jax({}, tree(stats_step1)),
            "grads": state_dict_from_jax(tree(applied)),
            "losses": losses, "optimizer_steps": W.STEPS // k}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (`_torch_ddp_worker.main`); JAX's steps are
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("ddp")
    torch.save({name: _start(name) for name in JAX_CASES}, tmp / "starts.pt")
    data = tmp / "data"
    make_synthetic_dataset(data, shape=(22, 20, 18), num_classes=4, n_train=2, n_val=1,
                           n_test=1, spacing=(1.5, 1.5, 2.0), seed=2)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ddp_worker.py"), str(r), str(WORLD),
         str(tmp / "rdzv"), str(tmp), str(data), str(tmp / "starts.pt")], env=env, cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for name in JAX_CASES:
            _jax_steps(name)
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def _one_process(name: str) -> dict:
    return W.run_steps(_case(name), 0, 1, _start(name))


def _held(got: dict, want: dict, what: str, per_update: bool = False) -> None:
    """`got` (`W.run_steps`) against `want` under the gates of the module
    docstring.  `per_update`: the parameters after the first update within
    the W5 bound and the last ones within it times the updates taken.
    W5 is one Adam update's bound: an element whose true gradient is 0
    (a conv bias ahead of a training batch norm) moves by lr x the sign
    of its rounding noise at every update, so two programs that round
    differently (JAX and the port) can part by up to 2 lr an update,
    where two runs of the port round alike."""
    assert got["optimizer_steps"] == want["optimizer_steps"] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=ATOL_LOSS)
    gaps = {n: float((g - want["grads"][n]).abs().max()) for n, g in got["grads"].items()}
    worst = max(gaps, key=gaps.get)
    print(f"{what}: gradient gap summed over {len(gaps)} leaves "
          f"{sum(gaps.values()):.3e}, worst {worst} {gaps[worst]:.2e}; losses "
          f"{got['losses']} vs {want['losses']}")
    assert sum(gaps.values()) <= ATOL_LEAF_SUM and gaps[worst] <= ATOL_LEAF
    # the gate bites: half the batch's gradient alone would not pass it
    assert sum(float(g.abs().max()) for g in want["grads"].values()) > 10 * ATOL_LEAF_SUM
    bounds = ((("params_step1", ATOL_STEP), ("params", ATOL_STEP * want["optimizer_steps"]))
              if per_update else (("params", ATOL_STEP),))
    for key, atol in bounds:
        for n, p in got[key].items():
            np.testing.assert_allclose(p.numpy(), want[key][n].numpy(), rtol=RTOL_STEP,
                                       atol=atol, err_msg=f"{what} {key} {n}")
    assert got["buffers"].keys() == want["buffers"].keys()
    for key, atol in (("buffers_step1", ATOL_STATS), ("buffers", (1 - MOMENTUM) * ATOL_STEP)):
        for n, b in got[key].items():
            np.testing.assert_allclose(b.numpy(), want[key][n].numpy(), rtol=1e-5,
                                       atol=atol, err_msg=f"{what} {key} {n}")


@pytest.mark.parametrize("case", sorted(W.STEP_CASES))
def test_two_ranks_step_like_one_process(ranks, case):
    want = _one_process(case)
    for r in range(WORLD):
        _held(ranks[r][case], want, f"{case} rank {r}")
    # the ranks agree with each other exactly: one all-reduce, one update
    for key in ("grads", "params", "buffers"):
        for n, v in ranks[0][case][key].items():
            assert torch.equal(v, ranks[1][case][key][n]), (key, n)
    assert ("batch" in case) == (len(want["buffers"]) > 0)


def test_accumulation_like_one_process(ranks):
    want = _one_process("accumulate")
    assert want["optimizer_steps"] == 1     # two micro-steps, one window
    for r in range(WORLD):
        _held(ranks[r]["accumulate"], want, f"accumulate rank {r}")


@pytest.mark.parametrize("who", ["one_process", "rank0", "rank1"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_step_like_jax_on_the_global_batch(ranks, case, who):
    want = _jax_steps(case)
    got = _one_process(case) if who == "one_process" else ranks[int(who[-1])][case]
    assert len(want["buffers"]) == 48 and want["optimizer_steps"] == (
        1 if case == "accumulate" else 2)
    _held(got, want, f"{case} {who} vs JAX", per_update=True)


@pytest.mark.parametrize("n,num_shards,shuffle", [(7, 2, True), (8, 2, False), (5, 3, True),
                                                  (4, 4, True)])
def test_loader_shards_are_jax_indices(n, num_shards, shuffle):
    data = list(range(n))
    for epoch in (0, 3):
        shards = []
        for shard in range(num_shards):
            got = D.DataLoader(data, batch_size=1, shuffle=shuffle, seed=5, shard=shard,
                               num_shards=num_shards)
            want = JD.DataLoader(data, batch_size=1, shuffle=shuffle, seed=5, shard=shard,
                                 num_shards=num_shards)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert np.array_equal(got._indices(), want._indices())
            assert len(got) == len(want)
            shards.append(got._indices())
        # DistributedSampler's padding: equal shards covering every item
        assert len({len(s) for s in shards}) == 1
        assert set(np.concatenate(shards)) == set(data)


def test_trial_broadcast(ranks):
    lead, follower = ranks[0]["tune"], ranks[1]["tune"]
    assert lead["is_study"] and not follower["is_study"]
    assert len(lead["seen"]) == len(follower["seen"]) == 3
    assert lead["seen"] == follower["seen"]
    numbers = [t["number"] for t in lead["trials"]]
    assert [s["number"] for s in lead["seen"]] == numbers == [0, 1, 2]
    for seen, trial in zip(lead["seen"], lead["trials"]):
        # the study's own values are float64; every rank trains on their
        # float32 rounding, as JAX's multi-host trial does
        for name, v in trial["params"].items():
            if isinstance(v, float):
                assert seen["params"][name] == float(np.float32(v)), name
        assert seen["lr"] == seen["params"]["lr"]
        assert seen["feature_size"] == [trial["params"]["feature_size"]]
        assert seen["num_heads"] == trial["params"]["num_heads"]
    assert any(float(np.float32(t["params"]["lr"])) != t["params"]["lr"]
               for t in lead["trials"])


def test_one_checkpoint_writer(ranks):
    lead, follower = ranks[0]["fit"], ranks[1]["fit"]
    assert follower["writes"] == []
    names = {Path(w).name for w in lead["writes"]}
    assert {"best.ckpt", "last.ckpt"} <= names
    assert all(Path(w).exists() or "epoch" in Path(w).name for w in lead["writes"])
    # two train volumes a modality, one crop each, sharded over two ranks
    assert lead["steps"] == follower["steps"] == 2
    assert lead["test_dice"] == follower["test_dice"]
    for n, p in lead["params"].items():
        assert torch.equal(p, follower["params"][n]), n


def test_mesh_and_unported_modes(ranks):
    """Every mode builds at world 2 (on a 1-D "data" mesh tensor
    parallelism has no "model" axis, so it places nothing, and the
    pipeline and spatial modes have no line of more than one rank, so
    their step is the data-parallel one, as in JAX); spatial partitioning
    over a line of two ranks builds beside FSDP on that line and beside
    tensor parallelism too, and two axes under one mesh size raise.  A
    mesh whose product is not the world size raises ValueError (JAX's
    `make_mesh` rule); any axis name is taken, at one process too."""
    for r in range(WORLD):
        said = ranks[r]["mesh"]
        for name in ("mesh_-1", "mesh_2", "fsdp", "tensor_parallel", "pipeline_parallel",
                     "spatial_shard", "spatial_fsdp", "spatial_fsdp_tp"):
            assert said[name] is None, (name, said[name])
        steps = said["pp_off_step"]
        assert steps["pipeline_parallel"] == steps["data"], steps
        assert steps["data"] == ranks[0]["mesh"]["pp_off_step"]["data"]
        for name in ("mesh_4", "mesh_1"):
            assert said[name].startswith("ValueError") and "!= 2 ranks" in said[name], name
        assert said["axes_model"].startswith("ValueError"), said["axes_model"]
    # one process: world 1
    assert host_shard_info() == (0, 1)
    for shape in ([1], [-1]):
        assert mesh_from_config(Config(mesh_shape=shape)).shape == (1,)
    with pytest.raises(ValueError, match=r"mesh shape \[2\] != 1 ranks"):
        mesh_from_config(Config(mesh_shape=[2]))
    mesh = mesh_from_config(Config(mesh_axes=["sp"]))
    assert (mesh.shape, mesh.axes) == ((1,), ("sp",))


def test_torchrun_environment_joins_at_world_one(tmp_path):
    """A process that torchrun started (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`/`MASTER_PORT`) joins its group through
    `parallel.init_process_group` even alone (gloo, asked for the CPU), so
    `torchrun --nproc_per_node=1` runs the data-parallel path, its "data"
    line the one-rank world; without that environment no group is made
    (`test_mesh_and_unported_modes`)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    code = ("import torch.distributed as dist\n"
            "from miseg_tpu_torch import parallel\n"
            "dev = parallel.init_process_group('cpu')\n"
            "print(dev, parallel.host_shard_info(), dist.get_backend(), "
            "parallel.group() is not None, parallel.data_group() is not None)\n"
            "dist.destroy_process_group()\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split("\n")[0] == "cpu (0, 1) gloo True True"
