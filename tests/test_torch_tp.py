"""Tensor parallelism in the port (`miseg_tpu_torch.parallel.tensor`,
`nn.layers.Linear`) on the CPU: four gloo ranks on a `[2, 2]` ("data",
"model") mesh, subprocesses spawned once for the module
(`tests/_torch_mesh_worker.py`), each held to a timeout, against one
process on the global batch and against the JAX package.

* Placements, with no spawn: the roles of tests/test_tensor_parallel.py:
  23-50 (the rank gate, the divisibility gate), and the port's claimed
  leaves and dims equal to JAX's `tp_param_shardings` on JAX's tiny UNETR
  and swin trees and the flagship's (fs 48) shapes, alone and with FSDP
  sharding the unclaimed leaves on the same axis.
* Steps: two AdamW steps of JAX's tiny UNETR (tests/test_tensor_parallel.py
  :137-149) and fs-12 swin (:53-60) under TP, and of the swin under TP +
  FSDP (`fsdp_axis="model"`), held to the port's one process on the
  global batch and to JAX's `value_and_grad` + optax step on it under the
  gates of `test_torch_fsdp.held`; the UNETR with dropout on under TP,
  held to one process only (JAX draws its masks from threefry keys, the
  port from a torch generator; what the case shows is the port's own
  contract that the column-sharded MLP activation keeps its columns of
  the mask one process draws); and the swin under TP + FSDP with
  `use_checkpoint` (each block recomputed in the backward, its
  collectives with it) and drop-path on, held to one process.
* Every rank ends on the same whole parameters; the claimed leaves'
  masters and moments are 1/2 on each rank.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_fsdp import (FLAGSHIP, copies_held, held, held_repeat_init, jax_mesh, jax_steps,
                             jax_tree, joined, one_process, placed, port_dims, spawn, start)

from miseg_tpu.parallel import tp_leaf_spec as j_tp_leaf_spec
from miseg_tpu.parallel import tp_param_shardings
from miseg_tpu_torch.parallel import tensor

import _torch_mesh_worker as W  # noqa: E402  (tests/ is on the path via test_torch_fsdp)

torch.set_num_threads(1)
STEP_CASES = ["tp_unetr", "tp_swin", "tp_fsdp"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results; JAX's steps and the one process are
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("tp")
    torch.save({m: start(m) for m in ("unetr", "swin")}, tmp / "starts.pt")
    procs = {"tp4": spawn("tp4", 4, tmp)}
    try:
        for name in STEP_CASES:
            jax_steps(name)
        for name in (*STEP_CASES, "tp_dropout", "tp_fsdp_recompute"):
            one_process(name)
    finally:
        out = joined(procs, tmp)
    return out["tp4"]


@pytest.mark.parametrize("path,shape,n", [
    (("mlp", "linear1", "kernel"), (12, 48), 2), (("mlp", "linear1", "bias"), (48,), 2),
    (("mlp", "linear2", "kernel"), (48, 12), 2), (("mlp", "linear2", "bias"), (12,), 2),
    (("attn", "qkv", "kernel"), (12, 36), 2), (("attn", "proj", "kernel"), (12, 12), 2),
    (("pm", "reduction", "kernel"), (96, 24), 2), (("embed", "proj", "kernel"), (2, 2, 2, 1, 12), 2),
    (("attn", "qkv", "kernel"), (7, 21), 2), (("enc", "conv1", "kernel"), (3, 3), 2),
    (("mlp", "linear1", "kernel"), (12, 48), 1), (("mlp", "linear1", "bias"), (47,), 2),
    (("attn", "qkv", "bias"), (36,), 2), (("x",), (8, 8), 2)])
def test_tp_leaf_spec_is_jax(path, shape, n):
    """tests/test_tensor_parallel.py:23-50's roles and gates (and a few
    more): the same flax dim, or unclaimed alike."""
    spec = j_tp_leaf_spec(path, shape, n, "model")
    want = None if spec is None else tuple(spec).index("model")
    assert tensor.tp_leaf_spec(path, shape, n) == want


@pytest.mark.parametrize("model", ["unetr", "swin", "flagship"])
@pytest.mark.parametrize("with_fsdp", [False, True])
def test_tp_placements_are_jax(model, with_fsdp):
    """The port's tensor-parallel leaves and dims (and with FSDP on the same
    axis, the unclaimed leaves') are JAX's `tp_param_shardings` on the
    same tree, mapped through the bridge's layouts."""
    model_cfg = FLAGSHIP if model == "flagship" else W.MODELS[model]
    tree = jax_tree(model_cfg)
    mesh = jax_mesh((2, 2), ("data", "model"))
    fs = dict(fsdp_axis="model", fsdp_min_size=128) if with_fsdp else {}
    specs = jax.tree.map(lambda s: s.spec, tp_param_shardings(tree, mesh, "model", **fs))
    want = port_dims(tree, specs, "model")
    got = placed(model_cfg, (2, 2), ("data", "model"), tensor_parallel=True,
                 **({"fsdp": True, **fs} if with_fsdp else {}))
    assert got == want
    roles = {n.rsplit(".", 2)[-2] for n in got}
    assert {"linear1", "linear2", "qkv", "proj"} <= roles
    assert ("reduction" in roles) == (model != "unetr")
    if not with_fsdp:   # only rank-2 Linear weights and linear1's bias
        assert all(n.endswith(".weight") or n.endswith("linear1.bias") for n in got)
    # the claimed weights' dims: column on torch's out dim, row on its in dim
    for n, d in got.items():
        role = n.rsplit(".", 2)[-2]
        if n.endswith(".weight") and role in ("linear1", "linear2", "qkv", "reduction"):
            assert d == (0 if role == "linear1" else 1), n


def test_tp_roles_on_a_live_jax_state_match():
    """Spot check of the JAX side the placements above are read from: the
    swin tree's MLP and qkv kernels carry the Megatron specs."""
    tree = jax_tree(W.MODELS["swin"])
    specs = tp_param_shardings(tree, jax_mesh((2, 2), ("data", "model")), "model")
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    by = {tuple(str(getattr(k, "key", k)) for k in p): s.spec for p, s in flat}
    assert any(k[-2:] == ("linear1", "kernel") and v == P(None, "model") for k, v in by.items())
    assert any(k[-2:] == ("qkv", "kernel") and v == P("model", None) for k, v in by.items())


@pytest.mark.parametrize("case", [*STEP_CASES, "tp_dropout", "tp_fsdp_recompute"])
def test_tp_steps_like_one_process(ranks, case):
    want = one_process(case)
    kinds = {"tp"} if case in ("tp_unetr", "tp_swin", "tp_dropout") else {"tp", "fsdp"}
    for r, res in enumerate(ranks):
        got = res[case]
        assert {k for k, *_ in got["placements"].values()} == kinds
        held(got, want, f"{case} rank {r}")
    for key in ("params", "grads"):
        for n, v in ranks[0][case][key].items():
            assert all(torch.equal(v, res[case][key][n]) for res in ranks[1:]), (key, n)


@pytest.mark.parametrize("who", ["one_process", "rank0", "rank3"])
@pytest.mark.parametrize("case", STEP_CASES)
def test_tp_steps_like_jax_on_the_global_batch(ranks, case, who):
    want = jax_steps(case)
    got = one_process(case) if who == "one_process" else ranks[int(who[-1])][case]
    held(got, want, f"{case} {who} vs JAX", per_update=True)


@pytest.mark.parametrize("case", ["tp_swin", "tp_fsdp"])
def test_tp_memory_share(ranks, case):
    """Masters + moments a rank: the replicated leaves' and half the
    placed ones' (both modes on the two-rank "model" axis)."""
    for r, res in enumerate(ranks):
        got = res[case]
        sharded = got["whole_bytes"] - got["replicated_bytes"]
        print(f"{case} rank {r}: {got['state_bytes']} of {got['whole_bytes']} bytes, "
              f"{got['replicated_bytes']} replicated")
        assert 0 < sharded and got["state_bytes"] <= got["replicated_bytes"] + sharded / 2
    if case == "tp_fsdp":
        assert ranks[0][case]["placed_elements"] > 0.5 * ranks[0][case]["elements"]


@pytest.mark.parametrize("case", W.COPIES["tp4"])
def test_tp_copies_averaged_over_every_rank(ranks, case):
    """A leaf TP does not claim is averaged over the "model" line of
    copies as over "data", so ranks whose copies differ (on the card, in
    their last bits) end with one set of bits; a TP or FSDP leaf's own
    axis is left out (`test_torch_fsdp.copies_held`)."""
    copies_held(ranks, case)


def test_tp_dropout_drops_columns_of_one_mask(ranks):
    """With dropout on, the ranks' losses are one process's (their masks
    are its mask's pieces), and differ from the run without dropout."""
    got, want = ranks[0]["tp_dropout"], one_process("tp_dropout")
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
    assert abs(got["losses"][0] - one_process("tp_unetr")["losses"][0]) > 1e-4


def test_repeat_init_state_keeps_parameters(ranks):
    """Under TP + FSDP at `[2, 2]` a second `init_state` without parameters
    starts from the current ones, and the state gathers to rank 0 alone."""
    held_repeat_init(ranks, start(W.CASES[W.REPEAT_INIT["tp4"]][0]))
