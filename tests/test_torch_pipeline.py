"""Pipeline parallelism in the port (`miseg_tpu_torch.parallel.pipeline`,
`models/unetr_pp.py`, `models/swin_unetr_pp.py`, the Trainer's GPipe
step) and the meshes it shares with the other modes, on the CPU: gloo
ranks as subprocesses (`tests/_torch_mesh_worker.py`), spawned once for
the module, two on the ("data", "pp") mesh `[1, 2]` and a "data" line
`[2]`, four on `[1, 4]`, `[2, 2]`, the ("data", "model", "pp") mesh `[1,
2, 2]`, the ("data", "sp", "pp"/"model") meshes `[1, 2, 2]` and a "data"
line `[4]`, and eight on `[1, 2, 4]` and `[2, 2, 2]`, each held to a
timeout, against one process on the global batch and against the JAX
package.

* The schedule (JAX's tests/test_pipeline.py:47-106): an affine stack,
  one layer a stage, where every stage boundary and this stage's
  gradients equal the serial stack's at 1, 2 and 4 microbatches, with
  shape-changing stages (`pipeline_apply_hetero`) and on `[2, 2]`; a layer
  count that does not divide raises.
* UNETR and Swin: JAX's tiny UNETR (:179-190, 4 layers) on 2 and 4 stages
  (the decoder's taps inside stages) and tiny swin (:283-290) on 4: the
  last stage's logits within 2e-4 of JAX's `unetr_pipeline_forward` /
  `swin_unetr_pipeline_forward` on the same mesh shape and of JAX's
  serial model (JAX's own tolerance, :209-210), bridged from the same
  seeded weights.
* The Trainer: dice_focal + AdamW steps of `W.MODELS`' UNETR on `[1, 2]`,
  `[1, 4]`, `[2, 2]` (one microbatch a data coordinate) and with an
  accumulation window, and of the swin on `[1, 4]` (also with
  `use_checkpoint`); beside FSDP on "data" (`[2, 2]`), on the pipeline
  line (`[1, 4]`, both models) and on "model" with tensor parallelism
  (`[1, 2, 2]`; the swin on `[1, 2, 4]`, TP inside its stages' patch
  merging), beside tensor parallelism alone and beside a "model" axis no
  mode claims (`[1, 2, 2]`), and on `[2, 2, 2]` with TP and FSDP on "pp"
  (the replicated leaves' all-reduce over a sub-mesh of four of the eight
  ranks); spatial partitioning beside the pipeline (C-UNETR on ("data",
  "sp", "pp") `[1, 2, 2]`, the swin on `[1, 2, 4]`), beside TP (both
  models on ("data", "sp", "model") `[1, 2, 2]`, the swin with FSDP on
  "model" too) and beside a "model" axis of copies; TP over "data" (the
  swin on `[2]`, C-UNETR on `[4]` at a batch of 4, the swin with FSDP on
  "data" too): every rank's losses, gradients and
  parameters held to the port's one process on the global batch
  (`test_torch_fsdp.held`: loss 1e-5, each gradient leaf 5e-5, the W5
  bound), every rank's masters bitwise equal, and the first loss within
  1e-4 relative of JAX's on the global batch (JAX's :242-280, :349-380).
  Under the pipeline each FSDP line is gathered once a step and
  reduce-scattered once, on every rank of the line.  The gradient rule
  alone, on gradients that differ by rank as a card's copies may, gives
  every rank one set of bits for each replicated leaf.  A checkpoint
  written under PP (and under PP with FSDP on "pp") resumes in one
  process, and one process's under either.
* Every rank's messages and collectives (TP's, FSDP's, the spatial
  line's halos, gathers and merges, the gradient rule's), replayed under
  NCCL's rule (a rank's operations one after another, each waiting for
  its peers; gloo's sends never wait), meet their peers: no cycle of
  waits on any suite's meshes, `[1, 2, 2]` and `[1, 2, 4]` with a spatial
  line among them.
* Refusals: dropout, batch norm, the UNets, a batch the microbatches do
  not divide, a swin line of other than 4 stages (ValueError, JAX's); a
  pipeline or a patch's D on "data" (JAX's DuplicateSpecError, a
  ValueError naming it here) and a mesh without "data" or a spatial line
  (JAX's KeyError), each also held against JAX's Trainer; the meshes the
  port once refused step as one process.
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import seeded_params
from test_torch_fsdp import (ATOL_LOSS, copies_held, held, jax_mesh, jax_model, joined,
                             one_process, spawn, start)

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models.swin_unetr import SwinUNETR as JSwinUNETR
from miseg_tpu.models.swin_unetr_pp import swin_unetr_pipeline_forward as j_swin_pp
from miseg_tpu.models.unetr import UNETR as JUNETR
from miseg_tpu.models.unetr_pp import unetr_pipeline_forward as j_unetr_pp
from miseg_tpu_torch import parallel
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.parallel.mesh import _sub_meshes
from miseg_tpu_torch.parallel.pipeline import stage_layers
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from miseg_tpu_torch.weights import state_dict_from_jax

import _torch_mesh_worker as W  # noqa: E402  (tests/ is on the path via test_torch_fsdp)

torch.set_num_threads(1)
ATOL_LOGITS = 2e-4
SUITE_WORLDS = {"pp2": 2, "pp4": 4, "pp8": 8}
STEP_CASES = ["pp_unetr", "pp_accumulate", "pp_unetr4", "pp_unetr_dp", "pp_swin",
              "pp_swin_recompute", "pp_fsdp_data", "pp_fsdp_pp", "pp_fsdp_pp_unetr", "pp_tp",
              "pp_tp_fsdp", "pp_model_axis", "pp8_swin_tp_fsdp", "pp8_unetr_dp_tp_fsdp",
              "pp_sp_unetr", "pp8_sp_swin", "sp_tp_swin", "sp_tp_unetr", "sp_tp_fsdp",
              "sp_copies", "tp_data_swin", "tp_data_unetr4", "tp_fsdp_data"]
# cases whose one process is another's (the mesh and modes dropped, nothing else)
SAME_ONE_PROCESS = {**{c: "pp_unetr" for c in ("pp_unetr4", "pp_unetr_dp", "pp_fsdp_data",
                                               "pp_fsdp_pp_unetr", "pp_tp", "pp_tp_fsdp",
                                               "pp_model_axis", "pp8_unetr_dp_tp_fsdp",
                                               "pp_sp_unetr", "sp_tp_unetr", "sp_copies")},
                    **{c: "pp_swin" for c in ("pp_fsdp_pp", "pp8_swin_tp_fsdp", "pp8_sp_swin",
                                              "sp_tp_swin", "sp_tp_fsdp", "tp_data_swin",
                                              "tp_fsdp_data")}}
# (kind, axis) of each case's placed leaves (tensor parallelism's over
# "data" gathered a step, as FSDP's)
PLACED = {"pp_fsdp_data": {("fsdp", "data")}, "pp_fsdp_pp": {("fsdp", "pp")},
          "pp_fsdp_pp_unetr": {("fsdp", "pp")}, "pp_tp": {("tp", "model")},
          "pp_tp_fsdp": {("tp", "model"), ("fsdp", "model")},
          "pp8_swin_tp_fsdp": {("tp", "model"), ("fsdp", "model")},
          "pp8_unetr_dp_tp_fsdp": {("tp", "model"), ("fsdp", "pp")},
          "sp_tp_swin": {("tp", "model")}, "sp_tp_unetr": {("tp", "model")},
          "sp_tp_fsdp": {("tp", "model"), ("fsdp", "model")},
          "tp_data_swin": {("fsdp", "data")}, "tp_data_unetr4": {("fsdp", "data")},
          "tp_fsdp_data": {("fsdp", "data")}}
FSDP_CASES = [c for c, kinds in PLACED.items() if any(k == "fsdp" for k, _ in kinds)]
_COND = ("instance_cond", {"num_styles": 2, "affine": True})
_JNORMS = dict(vit_norm=_COND, encoder_norm=_COND, decoder_norm=("instance", {"affine": True}))
JTINY = {  # tests/test_pipeline.py's `_tiny_unetr` and `_tiny_swin`
    "tiny_unetr": lambda: JUNETR(in_channels=1, out_channels=3, img_size=(32, 32, 32),
                                 feature_size=4, hidden_size=16, mlp_dim=32, num_heads=2,
                                 num_layers=4, **_JNORMS),
    "tiny_swin": lambda: JSwinUNETR(img_size=(32, 32, 32), in_channels=1, out_channels=3,
                                    depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                                    feature_size=12, **_JNORMS),
}


@functools.lru_cache(maxsize=None)
def jax_tiny(name: str):
    """(JAX module, seeded params) of a tiny model."""
    x, mods = W.tiny_inputs()
    model = JTINY[name]()
    return model, seeded_params(model, jnp.asarray(x[:1]), jnp.asarray(mods[:1]))


@functools.lru_cache(maxsize=None)
def jax_tiny_logits(name: str, n_stages: int) -> dict:
    """JAX's pipeline forward on a `[1, n_stages]` mesh (2 microbatches)
    and its serial forward of the tiny model, on `W.tiny_inputs()`."""
    model, params = jax_tiny(name)
    x, mods = (jnp.asarray(a) for a in W.tiny_inputs())
    forward = j_unetr_pp if name == "tiny_unetr" else j_swin_pp
    pp = forward(model, params, x, mods, mesh=jax_mesh((1, n_stages), ("data", "pp")),
                 microbatches=2, data_axis="data")
    serial = jax.jit(lambda p, x, m: model.apply({"params": p}, x, m))(params, x, mods)
    return {"pp": np.asarray(pp), "serial": np.asarray(serial)}


@functools.lru_cache(maxsize=None)
def jax_first_loss(model: str, size: int = W.GLOBAL_BATCH) -> float:
    """JAX's loss of a `W.MODELS` model on the first global batch of
    `size`, from the seeded params the port's cases start from (the
    data-parallel step's loss, which its PP step must give: JAX's
    :242-280)."""
    cfg = W.MODELS[model]
    jmodel, params = jax_model(model)
    batch = W.global_batches(cfg, size=size)[0]
    loss_fn = JL.loss_from_config(JConfig(**cfg))

    @jax.jit
    def loss(p, image, label, mods):
        return loss_fn(jmodel.apply({"params": p}, image, mods, train=True)
                       .astype(jnp.float32), label)

    return float(loss(params, batch["image"], batch["label"][..., 0], batch["modality"]))


def one(case: str) -> dict:
    return one_process(SAME_ONE_PROCESS.get(case, case))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every suite's ranks' results; JAX's side and the one process are
    computed while the ranks run.  `one_unetr.ckpt`: the one process's
    UNETR state after one step, for the ranks to resume."""
    tmp = tmp_path_factory.mktemp("pp")
    tiny = {name: state_dict_from_jax(jax_tiny(name)[1]) for name in JTINY}
    torch.save({"unetr": start("unetr"), "swin": start("swin"), **tiny}, tmp / "starts.pt")
    cfg = W.MODELS["unetr"]
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.init_state(start("unetr"))
    state, _ = trainer.train_step(state, W.global_batches(cfg, 1, seed=3)[0])
    save_checkpoint(tmp / "one_unetr.ckpt", params=trainer.state_dict(state),
                    opt_state=trainer.opt_state(state), epoch=0)
    procs = {suite: spawn(suite, world, tmp) for suite, world in SUITE_WORLDS.items()}
    try:
        for name, n in (("tiny_unetr", 2), ("tiny_unetr", 4), ("tiny_swin", 4)):
            jax_tiny_logits(name, n)
        for case in STEP_CASES:
            jax_first_loss(*_model_and_batch(case))
            one(case)
    finally:
        out = joined(procs, tmp)
    out["tmp"] = tmp
    return out


def _model_and_batch(case: str) -> tuple[str, int]:
    return W.CASES[case][0], W.BATCH.get(case, W.GLOBAL_BATCH)


def _suite(case: str) -> str:
    return next(s for s, cases in W.SUITES.items() if s in SUITE_WORLDS and case in cases)


# -------------------------------------------------------------- schedule

@pytest.mark.parametrize("run", ["m1", "m2", "m4", "hetero", "hybrid"])
def test_schedule_matches_serial(ranks, run):
    """Every stage's output (on the last stage of each line) and every
    stage's gradients equal the serial stack's: at 1, 2 and 4 microbatches
    on `[1, 4]`, with stages of widths 8 -> 6 -> 5 -> 4 -> 3, and on a
    `[2, 2]` mesh whose data coordinates run their halves of the batch."""
    res = [r["schedule"][run] for r in ranks["pp4"]]
    lasts = [3] if run != "hybrid" else [1, 3]
    for r, got in enumerate(res):
        assert (got["outputs"] is not None) == (r in lasts), (run, r)
        if got["outputs"] is not None:
            assert got["outputs"] <= 1e-5, (run, r, got)
        assert got["grads"] <= 1e-5, (run, r, got)


def unmatched(logs: list[list]) -> list:
    """Replay the ranks' logged messages and collectives (`W.logged_p2p`)
    under NCCL's rule: each rank runs its operations in its own order, a
    message waits for its peer's matching one and a collective for every
    rank of its group to reach the same one.  The ranks left waiting, with
    their next operation (empty: every operation met its peers)."""
    pos = [0] * len(logs)

    def head(r):
        return logs[r][pos[r]] if pos[r] < len(logs[r]) else None

    moved = True
    while moved:
        moved = False
        for a in range(len(logs)):
            op = head(a)
            if op is None:
                continue
            if len(op) == 2:
                kind, b = op
                peers = [b] if head(b) == ("recv" if kind == "send" else "send", a) else None
            else:
                peers = list(op[1]) if all(head(b) == op for b in op[1]) else None
            if peers is not None:
                for b in {a, *peers}:
                    pos[b] += 1
                moved = True
    return [(r, ops[p]) for r, (p, ops) in enumerate(zip(pos, logs)) if p < len(ops)]


@pytest.mark.parametrize("suite", list(SUITE_WORLDS))
def test_p2p_order_has_no_cycle(ranks, suite):
    """Every message and collective a suite's ranks posted (the schedule's,
    the forwards', every Trainer step's: TP's Megatron all-reduces inside
    the stages, FSDP's gathers and reduce-scatters, the gradient rule's)
    meets its peers when each operation waits for them, as NCCL's do on
    one stream; gloo's sends never wait, so the ranks' run alone would not
    show a cycle."""
    logs = [r["p2p"] for r in ranks[suite]]
    assert sum(len(op) == 2 for log in logs for op in log) > 0
    assert sum(len(op) == 3 for log in logs for op in log) > 0
    assert unmatched(logs) == []


@pytest.mark.parametrize("case", ["pp_sp_unetr", "pp8_sp_swin"])
def test_spatial_collectives_meet_beside_the_pipeline(ranks, case):
    """Spatial partitioning beside the pipeline: each stage's spatial line
    runs its gathers, halos and merges (all-gathers, and the merges' and
    the losses' all-reduces, over the ranks that share every coordinate
    but "sp") among its P2P messages, and replayed under NCCL's rule the
    case's two steps leave no rank waiting."""
    par = W.CASES[case][1]
    shape, axes = par["mesh_shape"], par["mesh_axes"]
    lines = {tuple(line) for line in _sub_meshes(tuple(shape), (axes.index("sp"),))}
    logs = [[op for step in res[case]["step_ops"] for op in step] for res in ranks[_suite(case)]]
    kinds = set()
    for r, log in enumerate(logs):
        on_line = {op[0] for op in log if len(op) == 3 and op[1] in lines and r in op[1]}
        assert "all_gather" in on_line and any(len(op) == 2 for op in log), (case, r)
        kinds |= on_line
    assert "all_reduce" in kinds
    assert unmatched(logs) == []


def test_sub_meshes_are_row_major():
    """The ranks of each sub-mesh `make_mesh` makes a group of (a line, or
    the axes of a leaf's summed and averaged gradient) are those that
    share the other axes' coordinates, row-major as JAX reshapes its
    devices; `Mesh.subgroup` drops the axes without a group and takes the
    world where the sub-mesh is every rank."""
    ranks = np.arange(8).reshape(2, 2, 2)
    assert _sub_meshes((2, 2, 2), (0, 2)) == [list(ranks[:, k, :].ravel()) for k in range(2)]
    assert _sub_meshes((2, 2, 2), (1,)) == [list(ranks[i, :, j]) for i in range(2)
                                            for j in range(2)]
    assert _sub_meshes((1, 4), (0, 1)) == [[0, 1, 2, 3]]
    mesh = parallel.Mesh((2, 1, 4), ("data", "model", "pp"), (1, 0, 2),
                         {"data": "data line", "model": None, "pp": "pp line"})
    assert mesh.subgroup(("model",)) is None and mesh.subgroup(()) is None
    assert mesh.subgroup(("pp", "model")) == "pp line"
    assert mesh.subgroup(("data", "model", "pp")) is torch.distributed.group.WORLD


def test_uneven_layers_rejected():
    """JAX's `stack_stages` rule: stages must divide the layers."""
    with pytest.raises(ValueError, match="do not split"):
        stage_layers(5, 2, 0)
    assert [stage_layers(12, 4, s) for s in range(4)] == [range(0, 3), range(3, 6),
                                                          range(6, 9), range(9, 12)]


# --------------------------------------------------------------- models

@pytest.mark.parametrize("name,n_stages", [("tiny_unetr", 2), ("tiny_unetr", 4),
                                           ("tiny_swin", 4)])
def test_pipeline_forward_like_jax(ranks, name, n_stages):
    """The last stage's logits within 2e-4 of JAX's pipeline forward on
    the same mesh shape and of JAX's serial model; the other stages have
    none."""
    results = ranks[f"pp{n_stages}"] if n_stages == 2 else ranks["pp4"]
    got = [r["forward"][f"{name} {n_stages}"] for r in results]
    assert all(g is None for g in got[:-1])
    want = jax_tiny_logits(name, n_stages)
    logits = got[-1].numpy()
    assert logits.shape == (W.TINY_BATCH, 32, 32, 32, 3)
    print(f"{name} on {n_stages} stages: max |port - JAX pp| "
          f"{np.abs(logits - want['pp']).max():.2e}, vs JAX serial "
          f"{np.abs(logits - want['serial']).max():.2e}")
    np.testing.assert_allclose(logits, want["pp"], rtol=ATOL_LOGITS, atol=ATOL_LOGITS)
    np.testing.assert_allclose(logits, want["serial"], rtol=ATOL_LOGITS, atol=ATOL_LOGITS)


# -------------------------------------------------------------- trainer

@pytest.mark.parametrize("case", STEP_CASES)
def test_pp_steps_like_one_process(ranks, case):
    """Every rank's two steps within the gates of the port's one process
    on the global batch, and every rank's masters, gradients and losses
    bitwise equal."""
    results = ranks[_suite(case)]
    want = one(case)
    par = W.CASES[case][1]
    for r, res in enumerate(results):
        got = res[case]
        assert {(k, a) for k, _, a, _ in got["placements"].values()} == PLACED.get(case, set())
        assert (got["state_bytes"] < got["whole_bytes"]) == (case in PLACED)
        # the modes run: the patch partitioned (32 planes of D and H), the pipeline on
        assert got["sp_top"] == ((32, 32) if par.get("spatial_shard") else None)
        assert got["pipelined"] == par.get("pipeline_parallel", False)
        held(got, want, f"{case} rank {r}")
    for key in ("params", "params_step1", "grads"):
        for n, v in results[0][case][key].items():
            assert all(torch.equal(v, res[case][key][n]) for res in results[1:]), (key, n)
    assert all(res[case]["losses"] == results[0][case]["losses"] for res in results)
    if case == "pp_accumulate":
        assert want["optimizer_steps"] == 1     # two micro-steps, one window


@pytest.mark.parametrize("case", STEP_CASES)
def test_pp_first_loss_like_jax(ranks, case):
    """The first step's loss within 1e-4 relative of JAX's on the global
    batch (the data-parallel step's)."""
    want = jax_first_loss(*_model_and_batch(case))
    for res in ranks[_suite(case)]:
        assert math.isclose(res[case]["losses"][0], want, rel_tol=1e-4), (
            res[case]["losses"][0], want)


@pytest.mark.parametrize("case", W.COPIES["pp4"])
def test_copies_averaged_over_every_rank(ranks, case):
    """Beside the pipeline, a replicated leaf's gradient is summed over
    the pipeline line and averaged over "data" and a "model" line of
    copies, so ranks whose copies differ (on the card, in their last
    bits) end with one set of bits; a TP or FSDP leaf's own axis is left
    out (`copies_held`)."""
    copies_held(ranks["pp4"], case)


@pytest.mark.parametrize("case", FSDP_CASES)
def test_fsdp_reduce_scatter_once_a_step(ranks, case):
    """Under the pipeline each rank gathers its FSDP line once a step and
    reduce-scatters the line's gradients once (gloo: one all-reduce of the
    stacked pieces) where the line sums ("pp") or averages ("data") them,
    however many backward calls its stage makes; on "model", whose ranks
    hold copies, it takes its piece with no collective; and the ranks of
    the line run the same collectives over it in the same order."""
    results = ranks[_suite(case)]
    placed = results[0][case]["placements"]
    names = [n for n, (kind, *_) in placed.items() if kind == "fsdp"]
    _, _, axis, size = placed[names[0]]
    reduced = int(axis in ("data", "pp"))
    whole = one(case)["params"]
    shard = sum(whole[n].numel() // size for n in names)
    for step in range(W.STEPS):
        lines = {}
        for r, res in enumerate(results):
            ops = [op for op in res[case]["step_ops"][step] if len(op) == 3]
            gathers = [op for op in ops if op[0] == "all_gather" and op[2] == shard]
            scatters = [op for op in ops if op[0] == "all_reduce" and op[2] == size * shard]
            assert (len(gathers), len(scatters)) == (1, reduced), (case, r, step, ops)
            line = gathers[0][1]
            assert all(op[1] == line for op in scatters) and r in line and len(line) == size
            lines.setdefault(line, []).append([op for op in ops if op[1] == line])
        assert sum(map(len, lines.values())) == len(results)
        for line, seqs in lines.items():
            assert all(seq == seqs[0] for seq in seqs), (case, step, line)


def _written_resumes(ranks, suite: str, case: str) -> None:
    """What rank 0 of `suite` wrote for `case` (`W.checkpoints`) is the
    ranks' state, whole, and one process resumes it exactly."""
    ck = load_checkpoint(ranks["tmp"] / f"{case}.ckpt")
    trainer = engine.Trainer(Config(**W.MODELS["unetr"]), device="cpu")
    state = trainer.restore(trainer.init_state(start("unetr")), ck)
    results = [r["checkpoints"] for r in ranks[suite]]
    written = results[0]["written"]
    assert [(r["written"]["params"] is not None, r["written"]["opt_state"])
            for r in results] == [(True, True)] + [(False, False)] * (len(results) - 1)
    assert state.step == written["step"] == W.STEPS
    for n, p in trainer.state_dict(state).items():
        assert torch.equal(p, written["params"][n]), n
    got = W.moments(trainer, state)
    for r in results:
        for n, st in r["written"]["moments"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(got[n][k])), (n, k)


def _resumes_under(ranks, suite: str) -> None:
    """One process's checkpoint resumes on `suite`'s ranks (`W.checkpoints`)
    with its parameters and step, and the next step is one process's."""
    ck = load_checkpoint(ranks["tmp"] / "one_unetr.ckpt")
    cfg = W.MODELS["unetr"]
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.restore(trainer.init_state(start("unetr")), ck)
    want = W.run_steps(cfg, None, W.global_batches(cfg, 1, seed=7), trainer, state)
    for r, res in enumerate(ranks[suite]):
        got = res["checkpoints"]
        assert got["resumed"]["step"] == 1 and got["next"]["step"] == want["step"] == 2
        for n, p in got["resumed"]["params"].items():
            assert torch.equal(p, ck["params"][n]), n
        np.testing.assert_allclose(got["next"]["losses"], want["losses"], atol=1e-5)
        for n, p in got["next"]["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(), rtol=1e-4,
                                       atol=2.5e-4, err_msg=f"rank {r} {n}")


def test_pp_checkpoint_resumes_in_one_process(ranks):
    """What rank 0 writes under PP `[1, 2]` is the ranks' state, whole, and
    one process resumes it exactly."""
    _written_resumes(ranks, "pp2", "pp_unetr")


def test_one_process_checkpoint_resumes_under_pp(ranks):
    """One process's checkpoint resumes under PP `[1, 2]` with its
    parameters and step, and the next step is one process's."""
    _resumes_under(ranks, "pp2")


def test_pp_fsdp_checkpoint_resumes_in_one_process(ranks):
    """Under PP `[1, 4]` with FSDP on "pp" the line gathers the shards and
    moments to rank 0, which writes one process's whole state; one process
    resumes it exactly."""
    _written_resumes(ranks, "pp4", "pp_fsdp_pp_unetr")


def test_one_process_checkpoint_resumes_under_pp_fsdp(ranks):
    """One process's checkpoint resumes under PP `[1, 4]` with FSDP on "pp"
    (each rank keeping its slices) with its parameters and step, and the
    next step is one process's."""
    _resumes_under(ranks, "pp4")


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("name,error,match", [
    ("dropout", "ValueError", "dropout_rate == 0"),
    ("batch_norm", "ValueError", "mutable collections"),
    ("unet", "ValueError", "UNETR and SwinUNETR"),
    ("batch", "ValueError", "batch 2 not divisible by 3 microbatches"),
    ("swin_stages", "ValueError", "needs mesh\\['pp'\\] == 4 stages, got 2"),
    ("sp_pp", None, None),
    ("sp_tp", None, None),
    ("tp_data", None, None),
    ("pp_data", "ValueError", "PartitionSpec\\('data', 'data', None, None\\) has duplicate "
     "entries for `data`"),
    ("tp_on_sp", None, None),
    ("pp_on_sp", None, None),
    ("no_data", "KeyError", "'data'"),
    ("sp_on_data", "ValueError", "PartitionSpec\\('data', 'data'\\) has duplicate entries"),
])
def test_pp_refusals(ranks, name, error, match):
    """JAX's refusals with JAX's exception classes, on every rank (a
    pipeline or a patch's D on "data" beside its batch: JAX's
    DuplicateSpecError, here a ValueError naming its cause; a mesh of more
    than one rank without "data" or a spatial line: `shard_batch`'s
    KeyError); and the meshes the port once refused (spatial partitioning
    beside PP or TP, TP over "data" beside a "pp" axis of copies, TP or
    the pipeline on the spatial axis), whose first step is one process's
    (loss within 1e-5)."""
    suite = "pp2" if name in ("dropout", "batch_norm", "unet", "batch", "swin_stages",
                              "tp_on_sp", "pp_on_sp", "no_data", "sp_on_data") else "pp4"
    for r, res in enumerate(ranks[suite]):
        said = res["refusals"][name]
        if error is None:
            assert name in W.REFUSAL_STEPS
            assert abs(said - one("pp_unetr")["losses"][0]) <= ATOL_LOSS, (name, r, said)
            continue
        assert isinstance(said, str) and said.startswith(error + ":"), (name, r, said)
        assert re.search(match, said), (name, r, said)


@pytest.mark.parametrize("name,error,match", [
    ("pp_data", "DuplicateSpecError", "PartitionSpec\\('data', 'data', None, None\\)"),
    ("no_data", "KeyError", "'data'"),
    ("sp_on_data", "DuplicateSpecError", "PartitionSpec\\('data', 'data'\\)"),
])
def test_jax_refuses_as_the_port(tmp_path, name, error, match):
    """JAX's Trainer on XLA host devices refuses the same meshes at its
    first step, with the errors `test_pp_refusals` names."""
    from jax.sharding import Mesh as JMesh

    from miseg_tpu.train.engine import Trainer as JTrainer
    from miseg_tpu.utils.logging import MetricLogger as JMetricLogger

    cfg = {**W.MODELS["unetr"], **{
        "pp_data": dict(mesh_shape=[2, 2], mesh_axes=["data", "model"], pipeline_parallel=True,
                        pp_axis="data", pp_microbatches=1),
        "no_data": dict(mesh_shape=[2], mesh_axes=["model"], tensor_parallel=True),
        "sp_on_data": dict(mesh_shape=[2], spatial_shard=True, spatial_axis="data")}[name]}
    n = math.prod(cfg["mesh_shape"])
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(cfg["mesh_shape"]),
                 tuple(cfg.get("mesh_axes", ["data"])))
    trainer = JTrainer(JConfig(**cfg), mesh=mesh, workdir=str(tmp_path),
                       logger=JMetricLogger(None))
    batch = W.global_batches(cfg, 1)[0]
    state = trainer.init_state(batch["image"][:1], batch["modality"][:1])
    with pytest.raises(Exception) as raised:
        trainer.train_step(state, batch)
    assert type(raised.value).__name__ == error and re.search(match, str(raised.value))
