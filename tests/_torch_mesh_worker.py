"""One rank of the FSDP, tensor-parallel and pipeline-parallel CPU tests
(`tests/test_torch_fsdp.py`, `tests/test_torch_tp.py`,
`tests/test_torch_pipeline.py`).

    python tests/_torch_mesh_worker.py SUITE RANK WORLD RDZV_FILE OUT_DIR STARTS

Joins a gloo process group through a `file://` rendezvous, then runs the
cases of `SUITES[SUITE]` on its "data" coordinate's share of each global
batch (`batch_for`): `STEPS` AdamW micro-steps of each case's model on
its mesh, from the state dict of its model in the file `STARTS`
(`torch.save`d `{model: state dict}`), recording the parameters after the
first and the last update, the gradients the first update applied (from
the same parameters wherever it runs) and the losses, every tensor
gathered whole; the placements; and this rank's bytes of masters and
AdamW moments beside one process's.  Each suite calls `init_state` again
on the Trainer of one case (`REPEAT_INIT`) and gathers its state to rank
0 alone.  The "fsdp2" suite also evaluates a volume with the
sliding-window inferer under FSDP and under data parallelism, writes a
checkpoint of its FSDP state (rank 0, its tensors gathered to rank 0
alone), and resumes the one-process checkpoint `OUT_DIR/one.ckpt` under
FSDP and takes one more step.  Saves what it saw to
`OUT_DIR/<SUITE>_rank<RANK>.pt`.

The pipeline suites ("pp2", "pp4"; "pp8" runs its cases alone) add
`pp_extras`: the GPipe schedule on an affine stack against the serial
stack (outputs and gradients, at 1, 2 and 4 microbatches, shape-changing
stages, and a `[2, 2]` ("data", "pp") mesh), JAX's tiny UNETR and swin
(`TINY`, from the state dicts in `STARTS`) through the pipeline forwards,
the refusals, and the checkpoints of `checkpoints` for a pipeline case
("pp2") and for one with FSDP on the pipeline line ("pp4").  The "tp4"
and "pp4" suites also drive the gradient rule alone on gradients that
differ by rank (`copies_reduced`).  Every rank
logs its messages and collectives (`logged_p2p`), and each step's
share of them is kept with its case (`run_steps`' "step_ops").
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from miseg_tpu_torch import parallel  # noqa: E402
from miseg_tpu_torch.config import Config  # noqa: E402
from miseg_tpu_torch.models import UNETR, SwinUNETR  # noqa: E402
from miseg_tpu_torch.models.swin_unetr_pp import swin_unetr_pipeline_forward  # noqa: E402
from miseg_tpu_torch.models.unetr_pp import unetr_pipeline_forward  # noqa: E402
from miseg_tpu_torch.parallel import fsdp  # noqa: E402
from miseg_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_apply_hetero  # noqa: E402
from miseg_tpu_torch.train import engine  # noqa: E402
from miseg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

_STEP = dict(criterion="dice_focal", optim_name="adamw", lr=1e-4, reg_weight=1e-5,
             no_amp=True)
# JAX's own tiny configurations: the UNet of tests/test_fsdp.py:44-51, the
# UNETR of tests/test_tensor_parallel.py:137-149 and the fs-12 swin of
# its :53-60
MODELS = {
    "unet": dict(_STEP, model_name="unet", roi_x=16, roi_y=16, roi_z=16, out_channels=2,
                 feature_size=[8], num_layers=2, strides=[2], num_res_units=1,
                 encoder_norm_name="instance_cond", decoder_norm_name="instance"),
    "unetr": dict(_STEP, model_name="unetr", out_channels=3, feature_size=[4],
                  hidden_size=16, mlp_dim=32, num_heads=2, roi_x=32, roi_y=32, roi_z=32,
                  vit_norm_name="instance_cond", encoder_norm_name="instance_cond",
                  decoder_norm_name="instance"),
    "swin": dict(_STEP, model_name="swin_unetr", roi_x=32, roi_y=32, roi_z=32,
                 out_channels=3, feature_size=[12], num_heads=2, depth_swin_block=[1],
                 encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                 decoder_norm_name="instance"),
}
MESH_2X2 = dict(mesh_shape=[2, 2], mesh_axes=["data", "model"])


def pp(*shape: int, **kw) -> dict:
    """Pipeline parallelism on a ("data", "pp") mesh of `shape`, or on a
    ("data", "model", "pp") one for three sizes."""
    axes = ["data", "pp"] if len(shape) == 2 else ["data", "model", "pp"]
    return dict(mesh_shape=list(shape), mesh_axes=axes, pipeline_parallel=True, **kw)


def sp(shape: list[int], third: str, **kw) -> dict:
    """Spatial partitioning on a ("data", "sp", `third`) mesh of `shape`."""
    return dict(mesh_shape=shape, mesh_axes=["data", "sp", third], spatial_shard=True, **kw)


# FSDP on the leaves of 128 elements or more (the tiny models have few above
# JAX's default 8192)
def fsdp_on(axis: str) -> dict:
    return dict(fsdp=True, fsdp_axis=axis, fsdp_min_size=128)


# case -> (model, the parallelism fields)
CASES = {
    "fsdp": ("unet", dict(fsdp=True, fsdp_min_size=128)),
    "fsdp_accumulate": ("unet", dict(fsdp=True, fsdp_min_size=128, iters_to_accumulate=2)),
    "hybrid": ("unet", dict(MESH_2X2, fsdp=True, fsdp_axis="model", fsdp_min_size=128)),
    "tp_unetr": ("unetr", dict(MESH_2X2, tensor_parallel=True)),
    "tp_swin": ("swin", dict(MESH_2X2, tensor_parallel=True)),
    "tp_fsdp": ("swin", dict(MESH_2X2, tensor_parallel=True, fsdp=True, fsdp_axis="model",
                             fsdp_min_size=128)),
    "tp_dropout": ("unetr", dict(MESH_2X2, tensor_parallel=True, dropout_rate=0.1)),
    # the recompute of each block in the backward, drop-path on
    "tp_fsdp_recompute": ("swin", dict(MESH_2X2, tensor_parallel=True, fsdp=True,
                                       fsdp_axis="model", fsdp_min_size=128,
                                       use_checkpoint=True, dropout_path_rate=0.1)),
    # GPipe: 2 microbatches of the batch of 2 unless said; the [2, 2] mesh
    # has one sample a data coordinate
    "pp_unetr": ("unetr", pp(1, 2)),
    "pp_accumulate": ("unetr", pp(1, 2, iters_to_accumulate=2)),
    "pp_unetr4": ("unetr", pp(1, 4)),
    "pp_unetr_dp": ("unetr", pp(2, 2, pp_microbatches=1)),
    "pp_swin": ("swin", pp(1, 4)),
    "pp_swin_recompute": ("swin", pp(1, 4, use_checkpoint=True)),
    # GPipe beside FSDP (on "data", the pipeline line, the TP axis), tensor
    # parallelism and a "model" axis no mode claims (its ranks hold copies)
    "pp_fsdp_data": ("unetr", pp(2, 2, pp_microbatches=1, **fsdp_on("data"))),
    "pp_fsdp_pp": ("swin", pp(1, 4, **fsdp_on("pp"))),
    "pp_fsdp_pp_unetr": ("unetr", pp(1, 4, **fsdp_on("pp"))),
    "pp_tp": ("unetr", pp(1, 2, 2, tensor_parallel=True)),
    "pp_tp_fsdp": ("unetr", pp(1, 2, 2, tensor_parallel=True, **fsdp_on("model"))),
    "pp_model_axis": ("unetr", pp(1, 2, 2)),
    # the swin's four stages beside a TP line: the only case where TP meets
    # `PatchMerging.reduction` inside a stage
    "pp8_swin_tp_fsdp": ("swin", pp(1, 2, 4, tensor_parallel=True, **fsdp_on("model"))),
    # every axis of more than one rank: the replicated leaves' all-reduce
    # runs over the ("data", "pp") sub-mesh of four ranks (`Mesh.subgroup`)
    "pp8_unetr_dp_tp_fsdp": ("unetr", pp(2, 2, 2, pp_microbatches=1, tensor_parallel=True,
                                         **fsdp_on("pp"))),
    # spatial partitioning beside the pipeline: each (data, sp) coordinate
    # runs its own line; C-UNETR's ViT whole on every rank of a stage's
    # spatial line, the swin's stages on their levels' slabs
    "pp_sp_unetr": ("unetr", sp([1, 2, 2], "pp", pipeline_parallel=True)),
    "pp8_sp_swin": ("swin", sp([1, 2, 4], "pp", pipeline_parallel=True)),
    # spatial partitioning beside Megatron on "model" (and FSDP there), and
    # beside a "model" axis no mode claims
    "sp_tp_swin": ("swin", sp([1, 2, 2], "model", tensor_parallel=True)),
    "sp_tp_unetr": ("unetr", sp([1, 2, 2], "model", tensor_parallel=True)),
    "sp_tp_fsdp": ("swin", sp([1, 2, 2], "model", tensor_parallel=True, **fsdp_on("model"))),
    "sp_copies": ("unetr", sp([1, 2, 2], "model")),
    # tensor parallelism over "data", whose ranks hold different batches:
    # its leaves gathered whole a step, as FSDP's; and with FSDP on "data"
    "tp_data_swin": ("swin", dict(mesh_shape=[2], mesh_axes=["data"], tensor_parallel=True,
                                  tp_axis="data")),
    "tp_data_unetr4": ("unetr", dict(mesh_shape=[4], mesh_axes=["data"],
                                     tensor_parallel=True, tp_axis="data")),
    "tp_fsdp_data": ("swin", dict(mesh_shape=[2], mesh_axes=["data"], tensor_parallel=True,
                                  tp_axis="data", **fsdp_on("data"))),
}
# the global batch of a case, where it is not `GLOBAL_BATCH` (a "data" line
# of four ranks)
BATCH = {"tp_data_unetr4": 4}
SUITES = {"fsdp2": ["fsdp", "fsdp_accumulate"], "fsdp4": ["hybrid"],
          "tp4": ["tp_unetr", "tp_swin", "tp_fsdp", "tp_dropout", "tp_fsdp_recompute"],
          "pp2": ["pp_unetr", "pp_accumulate", "tp_data_swin", "tp_fsdp_data"],
          "pp4": ["pp_unetr4", "pp_unetr_dp", "pp_swin", "pp_swin_recompute", "pp_fsdp_data",
                  "pp_fsdp_pp", "pp_fsdp_pp_unetr", "pp_tp", "pp_tp_fsdp", "pp_model_axis",
                  "pp_sp_unetr", "sp_tp_swin", "sp_tp_unetr", "sp_tp_fsdp", "sp_copies",
                  "tp_data_unetr4"],
          "pp8": ["pp8_swin_tp_fsdp", "pp8_unetr_dp_tp_fsdp", "pp8_sp_swin"]}
# the case of each suite whose Trainer calls `init_state` again
REPEAT_INIT = {"fsdp2": "fsdp", "fsdp4": "hybrid", "tp4": "tp_fsdp"}
# the cases of each suite whose gradient rule `copies_reduced` drives
COPIES = {"tp4": ["tp_unetr", "tp_fsdp"], "pp4": ["pp_tp", "pp_tp_fsdp", "pp_model_axis"]}
GLOBAL_BATCH = 2
STEPS = 2
EVAL_SIZE = 24


def case_config(name: str, *, one_process: bool = False) -> dict:
    """A case's Config fields; `one_process`: without its mesh and modes
    (the one process it is held to), keeping what changes the numbers."""
    model, par = CASES[name]
    if one_process:
        par = {k: v for k, v in par.items() if k in (
            "iters_to_accumulate", "dropout_rate", "dropout_path_rate", "use_checkpoint")}
    return dict(MODELS[model], **par)


def global_batches(cfg: dict, steps: int = STEPS, seed: int = 0,
                   size: int = GLOBAL_BATCH) -> list[dict]:
    """`steps` global batches of `size` for a model, from a seed,
    modalities alternating from 0."""
    rng = np.random.default_rng(seed)
    roi = (cfg["roi_x"], cfg["roi_y"], cfg["roi_z"])
    return [{"image": rng.standard_normal((size, *roi, 1)).astype(np.float32),
             "label": rng.integers(0, cfg["out_channels"], (size, *roi, 1)).astype(np.int32),
             "modality": (np.arange(size) % 2).astype(np.int32)} for _ in range(steps)]


def case_batches(name: str, steps: int = STEPS) -> list[dict]:
    """A case's global batches (`BATCH`'s size or `GLOBAL_BATCH`)."""
    return global_batches(MODELS[CASES[name][0]], steps, size=BATCH.get(name, GLOBAL_BATCH))


def batch_for(batch: dict) -> dict:
    """This rank's share of a global batch: its "data" coordinate's."""
    shard, shards = parallel.host_shard_info()
    n = len(batch["image"]) // shards
    return {k: v[shard * n:(shard + 1) * n] for k, v in batch.items()}


def whole(trainer, tensors: dict) -> dict:
    """`tensors` by master name (shards where placed), gathered whole, on
    the CPU."""
    return {n: t.detach().clone() for n, t in
            fsdp.gather_full(tensors, trainer.placements).items()}


def moments(trainer, state) -> dict:
    """AdamW's moments and step count by parameter name, whole."""
    sd = trainer.opt_state(state)["optimizer"]["state"]
    names = trainer._opt_names(state)
    return {names[int(i)]: {k: v.clone() for k, v in st.items()} for i, st in sd.items()}


def run_steps(cfg: dict, start: dict, batches: list[dict] | None = None,
              trainer=None, state=None) -> dict:
    """The record of `W.run_steps`-like micro-steps of `cfg` from the state
    dict `start` (or `trainer` and `state` as they are), on this
    process's share of each global batch."""
    if trainer is None:
        trainer = engine.Trainer(Config(**cfg), device="cpu")
        state = trainer.init_state(start)
    losses, params1, grads1, updates = [], None, None, optimizer_steps(state)
    step_ops = []
    for batch in batches if batches is not None else global_batches(cfg):
        logged = len(LOG)
        state, loss = trainer.train_step(state, batch_for(batch))
        step_ops.append(LOG[logged:])
        losses.append(float(loss))
        if grads1 is None and optimizer_steps(state) > updates:
            params1 = {n: t.detach().clone() for n, t in trainer.state_dict(state).items()}
            grads1 = whole(trainer, {n: p.grad for n, p in state.params.items()})
    # f32 master + AdamW's two moments of each optimised parameter, whole
    sizes = {n: 12 * int(np.prod(trainer._full_shapes[n])) for n in trainer._opt_names(state)}
    placed = [n for n in state.params if n in trainer.placements]
    return {"params": {n: t.detach().clone() for n, t in trainer.state_dict(state).items()},
            "params_step1": params1,
            "grads": grads1,
            "buffers": {n: b.clone() for n, b in state.buffers.items()},
            "losses": losses, "optimizer_steps": optimizer_steps(state),
            "step": state.step, "step_ops": step_ops,
            "sp_top": trainer._sp_top, "pipelined": trainer._pp_active(),
            "placements": {n: (pl.kind, pl.dim, pl.axis, pl.size)
                           for n, pl in trainer.placements.items()},
            "state_bytes": trainer.state_bytes(state),
            "whole_bytes": sum(sizes.values()),
            "replicated_bytes": sum(b for n, b in sizes.items() if n not in trainer.placements),
            "placed_elements": sum(int(np.prod(trainer._full_shapes[n])) for n in placed),
            "elements": sum(int(np.prod(s)) for s in trainer._full_shapes.values())}


def optimizer_steps(state) -> int:
    steps = [int(s["step"]) for s in state.optimizer.state.values() if "step" in s]
    return max(steps) if steps else 0


def eval_logits(start: dict) -> dict:
    """A 24^3 volume through `make_inferer` under FSDP and under data
    parallelism, from the same weights."""
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.standard_normal((1, EVAL_SIZE, EVAL_SIZE, EVAL_SIZE, 1))
                             .astype(np.float32))
    mods = torch.tensor([1], dtype=torch.int32)
    out = {}
    for name, cfg in (("fsdp", case_config("fsdp")), ("dp", MODELS["unet"])):
        trainer = engine.Trainer(Config(**cfg), device="cpu")
        trainer.init_state(start)
        with torch.no_grad():
            out[name] = trainer.make_inferer()(image, mods)
    return out


def repeat_init(name: str, start: dict) -> dict:
    """A case's Trainer whose `init_state` is called again: after
    `init_state(start)` (the parameters it gives, whole) and after one
    step (those of the step, and what `state_dict` and `opt_state`
    gathered to rank 0 alone give on this rank: None off rank 0)."""
    def copy(tensors):   # the replicated leaves are the masters themselves
        return None if tensors is None else {n: t.detach().clone() for n, t in tensors.items()}

    cfg = case_config(name)
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    trainer.init_state(start)
    again = copy(trainer.state_dict(trainer.init_state()))
    state, _ = trainer.train_step(trainer.init_state(), batch_for(global_batches(cfg, 1)[0]))
    stepped, stepped_moments = copy(trainer.state_dict(state)), moments(trainer, state)
    to_writer = copy(trainer.state_dict(state, dst=0))
    opt_to_writer = trainer.opt_state(state, dst=0)
    after_step = copy(trainer.state_dict(trainer.init_state()))
    names = trainer._opt_names(state)
    return {"again": again, "stepped": stepped, "after_step": after_step,
            "stepped_moments": stepped_moments, "to_writer": to_writer,
            "moments_to_writer": None if opt_to_writer is None else {
                names[int(i)]: st for i, st in opt_to_writer["optimizer"]["state"].items()}}


def copies_reduced(names: list[str], start: dict) -> dict:
    """`Trainer._reduce_grads` on gradients that differ by rank, as two
    ranks' copies of one gradient may on the card: each master's gradient
    is its draw from one seeded stream (the same on every rank) times
    `1 + rank / 8`.  By case: the draws and the reduced gradients by
    master name (this rank's pieces where placed)."""
    out = {}
    for name in names:
        trainer = engine.Trainer(Config(**case_config(name)), device="cpu")
        state = trainer.init_state(start[CASES[name][0]])
        gen = torch.Generator().manual_seed(11)
        drawn = {n: torch.randn(p.shape, generator=gen) for n, p in state.params.items()}
        params = list(state.params.values())
        for p, d in zip(params, drawn.values()):
            p.grad = d * (1 + dist.get_rank() / 8)
        trainer._reduce_grads([p.grad for p in params], params)
        out[name] = {"drawn": drawn,
                     "reduced": {n: p.grad.clone() for n, p in state.params.items()}}
    return out


def reduced_factor(case: str, rank: int, placed_axis: str | None) -> float:
    """What `copies_reduced` leaves of a leaf's gradient on global rank
    `rank`, as a multiple of its draw: each rank's `1 + r / 8` summed over
    the sub-mesh through `rank` of every axis but the leaf's own
    (`placed_axis`), divided by the sizes of the averaged axes ("data",
    whose ranks hold batches, and "model", whose ranks hold copies; the
    pipeline line sums its stages' parts)."""
    par = CASES[case][1]
    shape, axes = par["mesh_shape"], par["mesh_axes"]
    mine = np.unravel_index(rank, shape)
    free = [i for i, a in enumerate(axes) if a != placed_axis and shape[i] > 1]
    total = sum(1 + r / 8 for r in range(int(np.prod(shape)))
                if all(c == mine[i] for i, c in enumerate(np.unravel_index(r, shape))
                       if i not in free))
    return total / np.prod([shape[i] for i in free if axes[i] != "pp"])


def checkpoints(start: dict, out_dir: Path, case: str = "fsdp", one: str = "one.ckpt") -> dict:
    """The state of `case` after `STEPS` steps written as a checkpoint by
    rank 0 (`<case>.ckpt`); and the one-process checkpoint `one` resumed
    under the case: its parameters, moments and step as restored, and one
    more step."""
    cfg = case_config(case)
    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.init_state(start)
    for batch in global_batches(cfg):
        state, _ = trainer.train_step(state, batch_for(batch))
    # gathered to rank 0 alone, as `Trainer.fit` does; None elsewhere
    weights, opt_state = trainer.state_dict(state, dst=0), trainer.opt_state(state, dst=0)
    if parallel.is_writer():
        save_checkpoint(out_dir / f"{case}.ckpt", params=weights, opt_state=opt_state, epoch=0)
    parallel.barrier()
    written = {"params": None if weights is None else {n: t.clone() for n, t in weights.items()},
               "opt_state": opt_state is not None,
               "moments": moments(trainer, state), "step": state.step}

    trainer = engine.Trainer(Config(**cfg), device="cpu")
    state = trainer.restore(trainer.init_state(start), load_checkpoint(out_dir / one))
    resumed = {"params": {n: t.clone() for n, t in trainer.state_dict(state).items()},
               "moments": moments(trainer, state), "step": state.step}
    nxt = run_steps(cfg, start, global_batches(cfg, 1, seed=7), trainer, state)
    return {"written": written, "resumed": resumed, "next": nxt}


# JAX's tiny UNETR (tests/test_pipeline.py:179-190, 4 layers) and swin
# (:283-290), built as the port's modules
_COND = ("instance_cond", {"num_styles": 2, "affine": True})
_NORMS = dict(vit_norm=_COND, encoder_norm=_COND, decoder_norm=("instance", {"affine": True}),
              device="cpu")
TINY = {
    "tiny_unetr": lambda: UNETR(in_channels=1, out_channels=3, img_size=(32, 32, 32),
                                feature_size=4, hidden_size=16, mlp_dim=32, num_heads=2,
                                num_layers=4, **_NORMS),
    "tiny_swin": lambda: SwinUNETR(img_size=(32, 32, 32), in_channels=1, out_channels=3,
                                   depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                                   feature_size=12, **_NORMS),
}
TINY_BATCH = 2


def tiny_inputs(seed: int = 5):
    """The pipeline forwards' batch: `[TINY_BATCH, 32, 32, 32, 1]` and the
    modalities, from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((TINY_BATCH, 32, 32, 32, 1)).astype(np.float32),
            (np.arange(TINY_BATCH) % 2).astype(np.int32))


def pp_forward(name: str, state_dict: dict, n_stages: int):
    """A `TINY` model's logits through its pipeline forward on a `[1,
    n_stages]` ("data", "pp") mesh (2 microbatches), on this rank: the
    logits on the last stage, None elsewhere."""
    model = TINY[name]()
    model.load_state_dict(state_dict, strict=True)
    forward = unetr_pipeline_forward if name == "tiny_unetr" else swin_unetr_pipeline_forward
    mesh = parallel.make_mesh([1, n_stages], ["data", "pp"])
    x, mods = (torch.from_numpy(a) for a in tiny_inputs())
    with torch.no_grad():
        logits, _ = forward(model, x, mods, mesh=mesh, microbatches=2)
    return logits


def _affine(widths: list[int], seed: int = 3):
    """Seeded `tanh(h @ w + b)` layers from `widths[i]` to `widths[i + 1]`,
    and a batch of 8 inputs."""
    rng = np.random.default_rng(seed)
    layers = [(torch.tensor(rng.normal(size=(a, b)) * 0.3, dtype=torch.float32),
               torch.tensor(rng.normal(size=(b,)), dtype=torch.float32))
              for a, b in zip(widths, widths[1:])]
    return layers, torch.tensor(rng.normal(size=(8, widths[0])), dtype=torch.float32)


def _serial(layers, x):
    """Every layer's output and the gradients of `mean(out ** 2)` by layer."""
    params = [(w.clone().requires_grad_(), b.clone().requires_grad_()) for w, b in layers]
    outs, h = [], x
    for w, b in params:
        h = torch.tanh(h @ w + b)
        outs.append(h)
    h.square().mean().backward()
    return [o.detach() for o in outs], [(w.grad, b.grad) for w, b in params]


def schedule_run(widths: list[int], mesh, m: int, rows: slice = slice(None)) -> dict:
    """The affine stack of `widths` (one layer a stage) over the mesh's
    "pp" line, `m` microbatches, on `rows` of the batch, against the
    serial stack on the same rows: the largest gap of each stage's output
    (on the last stage; through `pipeline_apply` with each stage's output
    as a tap when the widths are equal, else `pipeline_apply_hetero`) and
    of this stage's gradients of `mean(out ** 2)`."""
    layers, x = _affine(widths)
    x = x[rows]
    want, want_grads = _serial(layers, x)
    s, n = mesh.index("pp"), mesh.size("pp")
    w, b = (t.clone().requires_grad_() for t in layers[s])

    def stage(h):
        return torch.tanh(h @ w + b)

    def tapped(h):
        y = stage(h)
        return y, [y] if s < n - 1 else []

    if len(set(widths)) == 1:
        out, schedule = pipeline_apply(tapped, x if s == 0 else None, mesh=mesh, microbatches=m,
                                       like=x, shape=(widths[0],), with_aux=True,
                                       aux=[1] * (n - 1) + [0])
        ys = None if out is None else [t[0] for t in out[1][:-1]] + [out[0]]
    else:
        ys, schedule = pipeline_apply_hetero([stage] * n, x if s == 0 else None, mesh=mesh,
                                             microbatches=m, like=x,
                                             shapes=[(c,) for c in widths])
    if ys is not None:
        ys[-1].square().mean().backward()
    schedule.backward()
    return {"outputs": None if ys is None else max(float((y - t).abs().max())
                                                    for y, t in zip(ys, want)),
            "grads": max(float((g - t).abs().max()) for g, t in zip((w.grad, b.grad),
                                                                   want_grads[s]))}


# the meshes of `pp_refusals` that step (C-UNETR from its start)
REFUSAL_STEPS = ("tp_on_sp", "pp_on_sp", "sp_pp", "sp_tp", "tp_data")


def pp_refusals(world: int, start: dict) -> dict:
    """What the Trainer says of each configuration JAX refuses, and of the
    meshes the port once refused: at world 2 on a `[1, 2]` mesh (and the
    KeyError of a mesh without "data"), at world 4 on the meshes of `[2,
    2]` and `[1, 2, 2]`.  By name: the error's type and message, or the
    first step's loss from `start` on the first global batch."""
    unetr = MODELS["unetr"]
    mesh_2x2 = dict(mesh_shape=[2, 2], mesh_axes=["data", "model"])
    sp_2 = dict(mesh_shape=[1, 2], mesh_axes=["data", "sp"], spatial_shard=True)
    cases = ({"dropout": {**unetr, **pp(1, 2, dropout_rate=0.1)},
              "batch_norm": {**unetr, **pp(1, 2), "encoder_norm_name": "batch"},
              "unet": {**MODELS["unet"], **pp(1, 2)},
              "batch": {**unetr, **pp(1, 2, pp_microbatches=3)},
              "swin_stages": {**MODELS["swin"], **pp(1, 2)},
              # an axis claimed twice: tensor parallelism gathers its leaves on
              # the spatial line; the pipeline takes it, the patch whole
              "tp_on_sp": {**unetr, **sp_2, "tensor_parallel": True, "tp_axis": "sp"},
              "pp_on_sp": {**unetr, **sp_2, "pipeline_parallel": True, "pp_axis": "sp"},
              "no_data": {**unetr, "mesh_shape": [2], "mesh_axes": ["model"],
                          "tensor_parallel": True},
              "sp_on_data": {**unetr, "mesh_shape": [2], "spatial_shard": True,
                             "spatial_axis": "data"}} if world == 2 else
             {"sp_pp": {**unetr, **pp(1, 2, 2), "mesh_axes": ["data", "sp", "pp"],
                        "spatial_shard": True},
              "sp_tp": {**unetr, "mesh_shape": [1, 2, 2], "mesh_axes": ["data", "model", "sp"],
                        "spatial_shard": True, "tensor_parallel": True},
              "tp_data": {**unetr, "mesh_shape": [2, 2], "mesh_axes": ["data", "pp"],
                          "tensor_parallel": True, "tp_axis": "data"},
              "pp_data": {**unetr, **mesh_2x2, "pipeline_parallel": True, "pp_axis": "data",
                          "pp_microbatches": 1}})
    out = {}
    for name, cfg in cases.items():
        try:
            trainer = engine.Trainer(Config(**cfg), device="cpu")
            state = trainer.init_state(start["unetr"] if name in REFUSAL_STEPS else None)
            _, loss = trainer.train_step(state, batch_for(global_batches(cfg, 1)[0]))
            out[name] = float(loss)
        except (KeyError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def pp_extras(world: int, start: dict, out_dir: Path) -> dict:
    """The pipeline suites' checks besides the Trainer cases ("pp8" has
    none)."""
    if world == 8:
        return {}
    out = {"refusals": pp_refusals(world, start)}
    if world == 2:
        out["forward"] = {"tiny_unetr 2": pp_forward("tiny_unetr", start["tiny_unetr"], 2)}
        out["checkpoints"] = checkpoints(start["unetr"], out_dir, "pp_unetr", "one_unetr.ckpt")
        return out
    out["forward"] = {f"{name} 4": pp_forward(name, start[name], 4) for name in TINY}
    line = parallel.make_mesh([1, 4], ["data", "pp"])
    out["schedule"] = {f"m{m}": schedule_run([6] * 5, line, m) for m in (1, 2, 4)}
    out["schedule"]["hetero"] = schedule_run([8, 6, 5, 4, 3], line, 2)
    hybrid = parallel.make_mesh([2, 2], ["data", "pp"])
    d = hybrid.index("data")
    out["schedule"]["hybrid"] = schedule_run([6] * 3, hybrid, 2, slice(4 * d, 4 * d + 4))
    out["checkpoints"] = checkpoints(start["unetr"], out_dir, "pp_fsdp_pp_unetr",
                                     "one_unetr.ckpt")
    return out


LOG: list = []   # this process's messages and collectives (`logged_p2p`)
_COLLECTIVES = ("all_reduce", "all_gather", "gather", "broadcast", "barrier",
                "all_gather_into_tensor", "reduce_scatter_tensor")


def logged_p2p(log: list) -> None:
    """Record in `log` every point-to-point message this process posts,
    `("send" | "recv", peer's global rank)`, and every collective the port
    calls (`torch.distributed.all_reduce`, `all_gather`, `gather`,
    `broadcast`, `barrier`: those of FSDP, TP's Megatron layers, the
    gradient rule, the state's gathers), `(name, the group's global ranks,
    elements)`, in program order: gloo's sends never block, so the tests
    replay the ranks' logs under NCCL's rule (a rank's messages and
    collectives run in its order, each waiting for its peers) to show the
    schedule cannot wait in a cycle there (`test_torch_pipeline`)."""
    isend, recv = dist.isend, dist.recv

    def logged_isend(tensor, dst, *args, **kwargs):
        log.append(("send", dst))
        return isend(tensor, dst, *args, **kwargs)

    def logged_recv(tensor, src, *args, **kwargs):
        log.append(("recv", src))
        return recv(tensor, src, *args, **kwargs)

    def logged(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            group = bound.get("group")
            ranks = (tuple(range(dist.get_world_size())) if group is None
                     else tuple(dist.get_process_group_ranks(group)))
            tensor = bound.get("tensor")
            log.append((name, ranks, 0 if tensor is None else tensor.numel()))
            return fn(*args, **kwargs)

        return call

    dist.isend, dist.recv = logged_isend, logged_recv
    for name in _COLLECTIVES:
        setattr(dist, name, logged(name, getattr(dist, name)))


def main(suite: str, rank: int, world: int, rdzv: str, out_dir: str, starts: str) -> None:
    torch.set_num_threads(1)
    start = torch.load(starts, weights_only=True)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    try:
        result = {"p2p": LOG}
        logged_p2p(LOG)
        for name in SUITES[suite]:
            result[name] = run_steps(case_config(name), start[CASES[name][0]],
                                     case_batches(name))
        if suite in REPEAT_INIT:
            name = REPEAT_INIT[suite]
            result["repeat_init"] = repeat_init(name, start[CASES[name][0]])
        if suite in COPIES:
            result["copies"] = copies_reduced(COPIES[suite], start)
        if suite.startswith("pp"):
            result.update(pp_extras(world, start, Path(out_dir)))
        if suite == "fsdp2":
            result["eval"] = eval_logits(start["unet"])
            result["checkpoints"] = checkpoints(start["unet"], Path(out_dir))
        result["host_shard_info"] = parallel.host_shard_info()
        torch.save(result, Path(out_dir) / f"{suite}_rank{rank}.pt")
    finally:
        parallel.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
         sys.argv[6])
