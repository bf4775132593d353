"""The training engine (counterpart of `miseg_tpu/train/engine.py`:
`TrainState` :53, `EarlyStopping` :60, `apply_fn` :106, `init_state`
:171 with its tensor-parallel and FSDP placements, `fresh_state` :234,
`train_step` :271, `flush_accumulation` :310, `make_inferer` :328,
`evaluate` :368 and `fit` :444).

The parameters are f32 masters.  A batch norm's running statistics are
f32 buffers of the model (`TrainState.buffers`): the training forward
updates them in place, evaluation reads them, and checkpoints carry
them beside the parameters (`Trainer.state_dict`).  The training forward casts every
floating parameter to the compute dtype (bf16 when `cfg.amp`) through a
differentiable cast and runs the model on those copies
(`torch.func.functional_call`), so the backward lands in the f32 masters;
the image is cast to the compute dtype and the logits to f32 before the
loss.  On the card every kernel of that forward (K1 and its fold, K2, K3,
K4, K5) runs inside its autograd Function.  Dropout draws from the
trainer's generator, seeded every step from `(cfg.seed + 1, step)` as the
JAX package's `fold_in(key(seed + 1), step)`, so a resumed run continues
the stream.

Evaluation (`make_inferer`, `evaluate`) runs the model in eval mode under
`inference_mode`, where the kernel wrappers launch directly and no
autograd Function runs, on one cast of the masters per call.  On a mesh
of more than one rank every rank evaluates every volume, and the
inferer fans the window groups out over the line of the mesh's first
axis (JAX's rule, miseg_tpu/train/engine.py:328-342): each rank predicts
its ⌈G/N⌉ groups, and the gathered logits are overlap-added in one
process's order on every rank.  `fit`
keeps host timings in `history`: the data module's set-up, each step's
wait on the loader and its CUDA-event time on the card, each epoch's,
validation's and checkpoint save's seconds, the windows evaluated and the
seconds of surface distance, the windows counted those this rank
predicted.

Under data parallelism (`parallel`, one rank a card) the Trainer runs
JAX's multi-host semantics: rank 0's initial state is broadcast, each
micro-step's gradients are averaged over the ranks in buckets (once a
window under `iters_to_accumulate`: the window's mean, as DDP's
`no_sync` micro-steps do), with the loss, so every rank logs the global
batch's; batch norm's statistics and the dropout masks are the global
batch's (`nn/norms.py`, `nn/dropout.py`); rank 0 alone writes
checkpoints and metrics, the others waiting at a barrier.

On a mesh with FSDP or tensor parallelism (`parallel.fsdp`,
`parallel.tensor`; JAX's placements, miseg_tpu/train/engine.py:193-212)
`TrainState.params` holds this rank's f32 shard of each placed leaf and
the whole of the others, and the optimizer runs on them.  The forward
gathers the FSDP shards once a step (`fsdp.gather_for_step`) and hands the
tensor-parallel shards to the Megatron layers (`nn.layers.Linear`); the
gradients of the replicated and tensor-parallel leaves (and of FSDP's
where its axis is not "data") are averaged over the "data" line and the
replicated leaves' over a "model" line of copies too, FSDP's on "data"
by their reduce-scatter after the backward.  `state_dict`, `opt_state`
and `eval_weights` gather whole tensors (a collective: every rank calls
them) and `restore` keeps the rank's slices, so checkpoints are one
process's whatever the mesh.  Beside spatial partitioning FSDP shards
over "data" or over the spatial line (JAX points `fsdp_axis` at either,
:205-211 and :281-290): see the next paragraph but one.

Under pipeline parallelism (`cfg.pipeline_parallel` on a mesh whose
`cfg.pp_axis` line has S > 1 ranks; JAX's :131-167) the step runs
C-UNETR's ViT blocks (`models/unetr_pp.py`) or C-Swin-UNETR's four swin
stages (`models/swin_unetr_pp.py`) as a GPipe over the line
(`parallel/pipeline.py`), one stage a rank; each coordinate of the other
axes ("data", "model") runs its own line.  Beside it FSDP may shard the
masters over "data", the pipeline line or the tensor-parallel axis (by
JAX's placements: a rank holds pieces of every stage's leaves), and
tensor parallelism runs Megatron inside the stages (D12).  Every term of
the loss runs on one rank of a line: stage 0 the patch embedding, the
last stage the decoder and the loss on the whole batch.  So each rank's
gradient is its stage's part, zeros elsewhere: the gradient rule
(`_reduce_grads`, D11) sums the pipeline line and averages "data" and
the copies of a "model" line, and each FSDP line, gathered
once before the schedule, is reduce-scattered once after its backward.
The loss comes back from the last stage the same way, and every rank
ends each step on the same masters.  Evaluation, state dicts and
checkpoints run the serial model on the gathered masters, as JAX's do.

Under spatial partitioning (`cfg.spatial_shard` on a mesh whose
`cfg.spatial_axis` line has N > 1 ranks; JAX's :281-290) each rank of the
line takes its D slab (H in 2-D) of the data coordinate's batch (`_batch`,
`parallel.shard_spatial_batch`) and runs the forward and the backward
under `spatial.partition`, where the layers exchange halos, merge their
norms' statistics and gather the levels the level rule leaves whole
(`parallel/spatial.py`); every rank's loss is the whole patch's.  Each
rank's gradient is its slab's part, so one all-reduce over every rank
sums the line and averages "data" (`all_reduce_mean(..., over=)`, once a
window under accumulation) and every rank keeps bitwise-equal masters; a
patch whose D the rule leaves whole runs replicated on the line, whose
ranks then hold copies of one gradient (averaged, D11).  With FSDP
each sharded leaf's gradient is counted once too: sharded over the
spatial line, its reduce-scatter after the backward sums the slabs'
parts (for a whole patch, whose ranks hold one gradient, it takes the
rank's piece), then the "data" line averages it; sharded over "data",
the reduce-scatter takes the "data" mean and the spatial line then sums
the slabs' parts (averages the copies of a whole patch); the replicated
leaves keep the all-reduce over the data x spatial ranks.  Evaluation
runs the whole model on gathered weights, its windows fanned out as
above.

Every mesh JAX lays out runs (ROADMAP D13): spatial partitioning beside
tensor parallelism (a "model" line's ranks share a slab), beside the
pipeline (each (data, spatial) coordinate runs its own pipeline line,
the step under the partition), beside lines of copies; tensor
parallelism over an axis whose ranks hold different activations keeps
JAX's placement and gathers its leaves a step as FSDP's.  The meshes JAX
refuses raise its errors at the first step (`_batch`, `_pp_apply`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from collections.abc import Callable, Mapping

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..config import Config
from ..parallel import fsdp, spatial
from ..parallel import tensor as tensor_parallel
from ..inferers import SlidingWindowInferer
from ..losses import loss_from_config
from ..metrics import (dice_score_labels, metric_by_modality, nanmean_valid,
                       reduce_mean_batch, surface_distance)
from ..models import UNETR, SwinUNETR, buffer_names, model_from_config
from ..models.swin_unetr_pp import swin_unetr_pipeline_forward
from ..models.unetr_pp import unetr_pipeline_forward
from ..nn import dropout
from ..utils.logging import MetricLogger
from ..utils.platform import resolve_device
from ..utils.profiling import profile_trace
from .checkpoint import (CheckpointManager, load_any_checkpoint_params, load_checkpoint,
                         save_checkpoint)
from .pretrained import load_swin_vit_torch
from .optim import (Accumulation, current_learning_rate, optimizer_from_config,
                    optimizer_step_count, set_learning_rate)
from .schedules import scheduler_from_config


@dataclasses.dataclass
class TrainState:
    """The f32 master parameters by name (the model's own tensors, updated
    in place), their optimizer, the count of micro-steps taken, the
    gradient accumulation window when `iters_to_accumulate` > 1, and the
    model's f32 buffers by name (batch norms' running statistics, the
    counterpart of JAX's `extra_vars`; the model's own tensors, updated in
    place by each training forward)."""
    params: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0
    accumulation: Accumulation | None = None
    buffers: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class EarlyStopping:
    """Stop after `patience` checks without an improvement of more than
    `min_delta` (mode "max" or "min")."""

    def __init__(self, patience: int = 6, min_delta: float = 1e-3, mode: str = "max"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: float | None = None
        self.bad = 0

    def update(self, value: float) -> bool:
        """True when training should stop."""
        improved = (self.best is None or
                    (self.mode == "max" and value > self.best + self.min_delta) or
                    (self.mode == "min" and value < self.best - self.min_delta))
        if improved:
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
        return self.bad >= self.patience


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for `step` of a run seeded `seed`."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0])


class _EvalInferer(SlidingWindowInferer):
    """A sliding-window inferer over the trainer's model in eval mode, on
    one cast of its masters a call (or a whole `evaluate`)."""

    def __init__(self, trainer: "Trainer", **kwargs):
        super().__init__(trainer._eval_window, **kwargs)
        self._trainer = trainer

    def __call__(self, inputs, modalities=None):
        with self._trainer.eval_weights():
            return super().__call__(inputs, modalities)


class _Pipelined(nn.Module):
    """A pipeline forward (`models/*_pp.py`) over `model` as a module, so
    that `torch.func.functional_call` runs it on substituted parameters."""

    def __init__(self, model: nn.Module, forward: Callable, **kwargs):
        super().__init__()
        self.model, self._forward, self._kwargs = model, forward, kwargs

    def forward(self, image, modalities):
        return self._forward(self.model, image, modalities, **self._kwargs)


class Trainer:
    def __init__(self, cfg: Config, model: nn.Module | None = None, *, device=None,
                 fused_conv: bool = True, workdir: str | None = None,
                 logger: MetricLogger | None = None):
        """`cfg`'s model on `device` (the CUDA card unless given; the CPU
        under `cfg.no_gpu`), or `model` as it is; `fused_conv` selects the
        conv blocks' path of a model built here.  Metrics go to `logger`,
        by default a `MetricLogger` over `workdir` (default
        `cfg.default_root_dir`) opened at the first record (on rank 0;
        the other ranks log nothing).  The mesh is `cfg`'s over the ranks
        (`parallel.mesh_from_config`), from now on the process's active one
        (that its dropout masks and batch statistics follow: run the steps
        of the Trainer built last)."""
        self.mesh = parallel.mesh_from_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device, no_gpu=cfg.no_gpu)
        self.model = model if model is not None else model_from_config(
            cfg, device=self.device, fused_conv=fused_conv)
        self.model.train()
        self._full_shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        self.placements: dict[str, fsdp.Placement] = {}
        self._masters: dict[str, torch.Tensor] | None = None
        self._placed_axes: dict[int, str] = {}   # id(placed master) -> its axis
        self.loss_fn = loss_from_config(cfg)
        self.scheduler = scheduler_from_config(cfg)
        self.compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
        self.workdir = workdir or cfg.default_root_dir
        self._logger = logger
        self._inferers: dict[str, _EvalInferer] = {}
        self._eval_cast: dict[str, torch.Tensor] | None = None
        self._generator: torch.Generator | None = None
        self._sp_top: tuple[int, int] | None = None   # the partitioned patch's (D, H)
        self.history: dict[str, list[float]] = {
            "setup_s": [], "loader_wait_s": [], "step_ms": [], "epoch_s": [], "val_s": [],
            "ckpt_s": [], "eval_windows": [], "surface_s": []}

    @property
    def logger(self) -> MetricLogger:
        if self._logger is None:
            writer = parallel.is_writer()
            self._logger = MetricLogger(self.workdir if writer else None, quiet=not writer)
        return self._logger

    # -------------------------------------------------------------- state

    def init_state(self, params: Mapping[str, torch.Tensor] | None = None) -> TrainState:
        """The initial state: the model's parameters and buffers (replaced
        by the state dict `params` when given, e.g. one bridged from JAX)
        as f32 masters, rank 0's on every rank, and `cfg`'s optimizer over
        the parameters (without the encoder's under `freeze_encoder`).  On
        a mesh with FSDP or tensor parallelism a placed leaf's master is
        this rank's shard (`self.placements`), and the model's own tensor
        of it is released."""
        self._materialize()
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        masters = dict(self.model.named_parameters())
        kept = buffer_names(self.model)
        buffers = {n: b for n, b in self.model.named_buffers() if n in kept}
        wrong = [n for n, p in {**masters, **buffers}.items() if p.dtype != torch.float32]
        if wrong:
            raise ValueError(f"master parameters and buffers must be float32: {wrong[:3]}")
        parallel.broadcast_tensors([*masters.values(), *buffers.values()])
        self.placements = fsdp.placements(self._full_shapes, self.mesh, self.cfg)
        tensor_parallel.attach(self.model, self.placements)
        for n, pl in self.placements.items():
            full = masters[n]
            masters[n] = nn.Parameter(pl.shard(full.detach()).clone())
            full.data = torch.empty(0, dtype=full.dtype, device=full.device)
        self._masters = masters
        # the placed leaves: their own axis holds pieces, not copies (FSDP's
        # reduce-scatter reduces it)
        self._placed_axes = {id(masters[n]): pl.axis for n, pl in self.placements.items()}
        optimizer = optimizer_from_config(self.cfg, masters,
                                          getattr(self.model, "ENCODER_PREFIXES", ()))
        k = self.cfg.iters_to_accumulate
        acc = Accumulation(k, self._reduce_grads) if k > 1 else None
        return TrainState(masters, optimizer, 0, acc, buffers)

    @torch.no_grad()
    def _materialize(self) -> None:
        """Give the model's parameters released by a sharded `init_state`
        their whole values again, gathered from the masters: a repeat
        `init_state` starts from the current parameters, as one process's
        does (every rank calls this)."""
        if not self.placements:
            return
        whole = fsdp.gather_full({n: self._masters[n] for n in self.placements},
                                 self.placements)
        for n, p in self.model.named_parameters():
            if n in whole:
                p.data = whole[n]

    def state_dict(self, state: TrainState,
                   dst: int | None = None) -> dict[str, torch.Tensor] | None:
        """The parameters and buffers of `state` by name, whole: what a
        checkpoint holds.  Placed leaves are gathered (every rank calls
        this), to every rank or with `dst` to global rank `dst` alone (the
        others get None); the others are the state's own tensors."""
        params = fsdp.gather_full(state.params, self.placements, dst)
        return None if params is None else {**params, **state.buffers}

    def state_bytes(self, state: TrainState) -> int:
        """Bytes of f32 masters and optimizer state this rank holds."""
        opt = [v for st in state.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.ndim > 0]
        return sum(t.numel() * t.element_size() for t in [*state.params.values(), *opt])

    def _line_rule(self, axis: str) -> str:
        """What the ranks of a line along `axis` hold of the gradient of a
        leaf no mode places on the axis: "mean" (different batches:
        "data"), "sum" (parts of one gradient: the pipeline line, the
        spatial line of a partitioned patch) or "copies" (of one gradient:
        "model" for a leaf TP does not claim, any axis no mode claims, the
        spatial line of a whole patch)."""
        if axis == "data":
            return "mean"
        if ((axis == self.cfg.pp_axis and self._pp_active())
                or (axis == self.cfg.spatial_axis and self._sp_top is not None)):
            return "sum"
        return "copies"

    def _fsdp_ops(self) -> dict[str, str | None]:
        """The op of an FSDP line's reduce-scatter on each axis: its
        `_line_rule`, but None (this rank's piece) on a line of copies:
        each piece has one owner there, so the copies cannot drift apart."""
        return {a: None if r == "copies" else r
                for a, r in ((a, self._line_rule(a)) for a in self.mesh.axes)}

    def _reduce_grads(self, grads: list[torch.Tensor], params: list[torch.Tensor],
                      extra: list[torch.Tensor] = ()) -> None:
        """The gradients (aligned with the optimizer's `params`) and `extra`
        (the loss) reduced in place over the mesh by one rule (ROADMAP D11):
        for each leaf and each axis, what the ranks of the axis' line hold:

        | the line's ranks hold  | axes                                   | reduction |
        |------------------------|----------------------------------------|-----------|
        | different batches      | "data"                                 | mean      |
        | parts of one gradient  | the pipeline line (a stage's part,     | sum       |
        |                        | zeros elsewhere); the spatial line of  |           |
        |                        | a partitioned patch (D7)               |           |
        | copies of one gradient | "model" for a leaf TP does not claim;  | mean      |
        |                        | an axis no mode claims; the spatial    |           |
        |                        | line of a whole patch                  |           |
        | pieces of one leaf     | the leaf's TP axis; its FSDP axis      | none here |

        Copies are averaged, not left alone: on the card two ranks' copies
        of one gradient differ in their last bits (cuDNN's backward
        kernels do not repeat them), and the all-reduce gives every rank
        the same bits.  A TP leaf's axis holds pieces, each one rank's;
        an FSDP leaf's was reduce-scattered after the backward with the op
        its axis would otherwise take, a line of copies giving each rank
        its own piece (`_fsdp_ops`, `fsdp.gather_for_step`).  The loss is
        the replicated leaves' rule but for the spatial line of a
        partitioned patch, whose ranks each hold the whole patch's: summed
        over the pipeline line (the last stage has it, the others 0) and
        averaged over "data" and the lines of copies.  The leaves that share their summed and averaged
        axes take one all-reduce over the sub-mesh of those axes
        (`Mesh.subgroup`), a sum divided by the averaged axes' sizes (a
        mean alone: NCCL's AVG), so every rank of it ends with the same
        bits; a leaf with neither takes none."""
        axes = [a for a in self.mesh.axes if self.mesh.group(a) is not None]
        rule = {a: self._line_rule(a) for a in axes}
        jobs: dict[tuple, list[torch.Tensor]] = {}

        def add(t: torch.Tensor, placed_on: str | None) -> None:
            summed = tuple(a for a in axes if rule[a] == "sum" and a != placed_on)
            meaned = tuple(a for a in axes if rule[a] != "sum" and a != placed_on)
            jobs.setdefault((summed, meaned), []).append(t)

        for t in extra:
            add(t, self.cfg.spatial_axis if self._sp_top is not None else None)
        for g, p in zip(grads, params):
            if g is not None:
                add(g, self._placed_axes.get(id(p)))
        for (summed, meaned), tensors in jobs.items():
            if summed or meaned:
                over = math.prod(self.mesh.size(a) for a in meaned) if summed else None
                parallel.all_reduce_mean(tensors, self.mesh.subgroup(summed + meaned),
                                         over=over)

    def fresh_state(self) -> TrainState:
        """`init_state`, then the ingest of weights from elsewhere
        (`miseg_tpu/train/engine.py:214-230`): `pre_swin_unetr` needs
        `cfg.pre_swin`, MONAI's Swin-ViT file, merged into `swinViT`; then
        `--pretrained`, a checkpoint of any format `load_any_checkpoint_params`
        reads (every tensor whose name and shape match)."""
        cfg = self.cfg
        state = self.init_state()
        params = self.state_dict(state)
        if cfg.model_name == "pre_swin_unetr":
            if not cfg.pre_swin:
                raise ValueError("pre_swin_unetr requires --pre_swin checkpoint path")
            params = load_swin_vit_torch(cfg.pre_swin, params)
            print("Loaded pre-trained Swin-ViT")
        if cfg.pretrained:
            print("Loading pre-trained weights ...")
            params = load_any_checkpoint_params(cfg.pretrained, params,
                                                model_name=cfg.model_name)
        params = {n: t.to(self.device) for n, t in params.items()}
        parallel.broadcast_tensors(list(params.values()))
        self._load_params(state, params)
        return state

    @torch.no_grad()
    def _load_params(self, state: TrainState, params: Mapping[str, torch.Tensor]) -> None:
        """Copy the whole tensors `params` into `state` (a placed leaf's
        master takes this rank's slice)."""
        own = {**state.params, **state.buffers}
        missing = [n for n in own if n not in params]
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} parameters or buffers, e.g. "
                           f"{missing[:3]}")
        for n, p in own.items():
            pl = self.placements.get(n)
            p.copy_(params[n] if pl is None else pl.shard(params[n].to(p.device)))

    def _opt_names(self, state: TrainState) -> list[str]:
        """The masters' names in the order of the optimizer's state dict."""
        names = {id(p): n for n, p in state.params.items()}
        return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]

    def opt_state(self, state: TrainState, dst: int | None = None) -> dict | None:
        """The optimizer's state as a checkpoint holds it, placed leaves'
        moments gathered whole (every rank calls this), to every rank or
        with `dst` to global rank `dst` alone (the others get None)."""
        acc = state.accumulation
        counts = (acc.state_dict() if acc is not None
                  else {"gradient_step": state.step, "mini_step": 0})
        sd = state.optimizer.state_dict()
        placed, pls = {}, {}
        for i, name in enumerate(self._opt_names(state)):
            pl = self.placements.get(name)
            for k, v in sd["state"].get(i, {}).items():
                if pl is not None and isinstance(v, torch.Tensor) and v.ndim > 0:
                    placed[(i, k)], pls[(i, k)] = v, pl
        whole = fsdp.gather_full(placed, pls, dst)
        if whole is None:
            return None
        sd = {**sd, "state": {i: {k: whole.get((i, k), v) for k, v in st.items()}
                              for i, st in sd["state"].items()}}
        return {"optimizer": sd, **counts}

    def _shard_opt_state(self, state: TrainState, sd: Mapping) -> Mapping:
        """An optimizer state dict of whole moments with this rank's slices
        of the placed leaves' (the inverse of `opt_state`'s gather)."""
        if not self.placements:
            return sd
        names = self._opt_names(state)
        out = {}
        for i, st in sd["state"].items():
            pl = self.placements.get(names[int(i)])
            out[i] = {k: pl.shard(v).clone() if pl is not None and isinstance(v, torch.Tensor)
                      and v.ndim > 0 else v for k, v in st.items()}
        return {**sd, "state": out}

    def restore(self, state: TrainState, ck: Mapping) -> TrainState:
        """Load a checkpoint's parameters and buffers and, when it has
        them, its optimizer state and step count into `state` (whatever
        mesh wrote it: its tensors are whole)."""
        self._load_params(state, ck["params"])
        opt_state = ck.get("opt_state")
        if opt_state:
            state.optimizer.load_state_dict(self._shard_opt_state(state, opt_state["optimizer"]))
            if state.accumulation is not None:
                state.accumulation.load_state_dict(opt_state)
            state.step = optimizer_step_count(opt_state, self.cfg.iters_to_accumulate)
        return state

    # ------------------------------------------------------------- forward

    def apply_fn(self, params: Mapping[str, torch.Tensor], image, modalities):
        """Forward under the compute policy: f32 logits of `image` from
        `params` cast to the compute dtype.  `params` are this rank's
        weights of a training step, FSDP's lines gathered whole and the
        tensor-parallel leaves as shards (`fsdp.gather_for_step`), or, with
        nothing placed, the masters themselves."""
        cast = {n: p.to(self.compute_dtype) if p.is_floating_point() else p
                for n, p in params.items()}
        logits = torch.func.functional_call(
            self.model, cast, (image.to(self.compute_dtype), modalities))
        return logits.float()

    def _sp_size(self) -> int:
        """The spatial line's size under `cfg.spatial_shard` (1: no spatial
        partitioning, JAX's rule at :281).  A pipeline on the same axis
        takes the line: its ranks hold stages, each the whole patch (GSPMD
        regathers D at the pipeline's `shard_map`; ROADMAP D13)."""
        cfg = self.cfg
        if not cfg.spatial_shard or (self._pp_active() and cfg.pp_axis == cfg.spatial_axis):
            return 1
        return self.mesh.size(cfg.spatial_axis)

    def _partition(self):
        """The spatial partition of the batch `_batch` placed last (a no-op
        context when none)."""
        if self._sp_top is None:
            return contextlib.nullcontext()
        axis = self.cfg.spatial_axis
        return spatial.partition(self.mesh.group(axis), self.mesh.size(axis),
                                 self.mesh.index(axis), *self._sp_top,
                                 ndim=self.cfg.spatial_dims + 2)

    def _pp_active(self) -> bool:
        """Pipeline parallelism runs when `cfg.pipeline_parallel` is set and
        the mesh's pipeline line has more than one rank; otherwise the step
        is the data-parallel one (JAX's :131-133)."""
        return self.cfg.pipeline_parallel and self.mesh.size(self.cfg.pp_axis) > 1

    def _pp_apply(self, weights: Mapping[str, torch.Tensor], image, modalities):
        """The pipeline-parallel training forward (JAX's :135-167) on the
        step's `weights` (`fsdp.gather_for_step`: FSDP's lines whole, their
        gradients summed over the schedule's many backward calls, a
        different number on each stage): `(f32 logits on the last stage,
        None on the others; the schedule)`.  The tensor-parallel shards go
        to the Megatron layers inside the stages (D12).  The UNETR and
        SwinUNETR families only, and no batch norm, else `ValueError`."""
        if isinstance(self.model, UNETR):
            forward = unetr_pipeline_forward
        elif isinstance(self.model, SwinUNETR):
            forward = swin_unetr_pipeline_forward
        else:
            raise ValueError("pipeline_parallel supports the UNETR and SwinUNETR transformer "
                             f"families; got {type(self.model).__name__}")
        if buffer_names(self.model):
            raise ValueError("pipeline_parallel does not support mutable collections "
                             "(batch-stats norms)")
        if self.cfg.pp_axis == "data" and image.shape[0] % self.cfg.pp_microbatches == 0:
            # JAX's pipeline maps the stages and the batch both on "data" (its
            # :165, miseg_tpu/parallel/pipeline.py:104-114); a local batch the
            # microbatches do not divide raises first, in the schedule, as there
            raise ValueError("pp_axis='data': the pipeline's stages and its batch would "
                             "both go on 'data': PartitionSpec('data', 'data', None, None) "
                             "has duplicate entries for `data` (JAX's DuplicateSpecError)")
        staged = _Pipelined(self.model, forward, mesh=self.mesh, axis=self.cfg.pp_axis,
                            microbatches=self.cfg.pp_microbatches, train=True)
        logits, schedule = torch.func.functional_call(
            staged, {f"model.{n}": t for n, t in weights.items()},
            (image.to(self.compute_dtype), modalities))
        return (None if logits is None else logits.float()), schedule

    @contextlib.contextmanager
    def eval_weights(self):
        """The model in eval mode, with the masters cast to the compute
        dtype once for every window run inside (the buffers stay f32);
        re-entrant."""
        if self._eval_cast is not None:
            yield
            return
        was_training = self.model.training
        masters = self._masters if self._masters is not None else dict(
            self.model.named_parameters())
        with torch.no_grad():
            self._eval_cast = {n: p.detach() for n, p in fsdp.full_weights(
                masters, self.placements, self.compute_dtype).items()}
        self.model.eval()
        try:
            yield
        finally:
            self._eval_cast = None
            self.model.train(was_training)

    def _eval_window(self, window, modalities):
        logits = torch.func.functional_call(
            self.model, self._eval_cast, (window.to(self.compute_dtype), modalities))
        return logits.float()

    def make_inferer(self, mode: str = "constant") -> SlidingWindowInferer:
        """A sliding-window inferer (one per blend `mode`, cached) over the
        model's current parameters, in eval mode and the compute dtype with
        f32 logits, under `inference_mode`; it stitches in host memory with
        `cfg.infer_cpu` and prints its progress with `cfg.infer_progress`.
        On a mesh of more than one rank it takes the mesh (JAX's :335), so
        its window groups fan out over the first axis' line: every rank of
        the mesh must call it on the same volumes."""
        if mode not in self._inferers:
            cfg = self.cfg
            self._inferers[mode] = _EvalInferer(
                self, roi_size=cfg.roi, sw_batch_size=cfg.sw_batch_size,
                overlap=cfg.infer_overlap, mode=mode,
                out_channels=cfg.out_channels, stitch_on_host=cfg.infer_cpu,
                progress=cfg.infer_progress, device=self.device,
                mesh=self.mesh if np.prod(self.mesh.shape) > 1 else None)
        return self._inferers[mode]

    # --------------------------------------------------------- train step

    def _to_device(self, x, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A host array or tensor on the trainer's device; on the card
        through pinned memory with a non-blocking copy."""
        t = torch.as_tensor(x)
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _batch(self, batch: Mapping):
        """(image, label, modality) on the device; under spatial
        partitioning this rank's D slab (H in 2-D) of the image and label
        when the level rule shards the patch's dim 1 (`_sp_top`, the
        patch's dims 1 and 2, says so)."""
        cfg, mesh = self.cfg, self.mesh
        sp_line = cfg.spatial_shard and mesh.size(cfg.spatial_axis) > 1
        if sp_line and cfg.spatial_axis == "data":
            # JAX's `shard_spatial_batch` (miseg_tpu/parallel/spatial.py:62-91)
            raise ValueError("spatial_axis='data': the batch's dims 0 and 1 would both go "
                             "on 'data': PartitionSpec('data', 'data') has duplicate entries "
                             "for `data` (JAX's DuplicateSpecError)")
        if not sp_line and math.prod(mesh.shape) > 1 and "data" not in mesh.axes:
            # JAX's `shard_batch` places the batch on mesh.shape["data"]
            # (miseg_tpu/parallel/mesh.py:59): a mesh of more than one rank
            # without that axis, or a spatial line, raises its KeyError
            raise KeyError("data")
        n_sp = self._sp_size()
        self._sp_top = None
        if n_sp > 1:
            depth, height = tuple(batch["image"].shape[1:3])
            if spatial.sharded_depth(depth, n_sp):
                self._sp_top = (depth, height)
                batch = spatial.shard_spatial_batch(
                    {k: v for k, v in batch.items() if k in ("image", "label", "modality")},
                    self.mesh, self.cfg.spatial_axis, data_axis=None)
        image = self._to_device(batch["image"])
        label = torch.as_tensor(batch["label"])
        if label.ndim == 5 and label.shape[-1] == 1:
            label = label[..., 0]
        label = self._to_device(label, None if label.device.type == "cuda" else torch.int32)
        mods = batch.get("modality")
        if mods is not None:
            mods = self._to_device(mods, torch.int32)
        return image, label, mods

    def _dropout_generator(self, step: int) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(step_seed(self.cfg.seed, step))
        return self._generator

    def value_and_grad(self, state: TrainState, batch: Mapping):
        """The loss of `batch` (image `[B, *S, Cin]`, integer label
        `[B, *S]` or `[B, *S, 1]`, modality `int[B]`) and the gradients of
        the masters by name, left in their `.grad`; nothing is updated.
        Under pipeline parallelism, this rank's part of both: the loss on
        the last stage (0 on the others), the gradient of what its stage
        ran (zeros for the rest); `train_step` sums them over the line.
        Under spatial partitioning, the whole patch's loss and this rank's
        slab's part of the gradients.  FSDP's lines are gathered once
        before the forward and reduce-scattered once after the backward
        (`fsdp.gather_for_step`)."""
        image, label, mods = self._batch(batch)
        for p in state.params.values():
            p.grad = None
        weights, scatter = fsdp.gather_for_step(state.params, self.placements,
                                                self.compute_dtype, self._fsdp_ops())
        if self._pp_active():
            with self._partition():
                logits, schedule = self._pp_apply(weights, image, mods)
                if logits is None:
                    loss = torch.zeros((), device=self.device)
                else:
                    loss = self.loss_fn(logits, label)
                    loss.backward()
                schedule.backward()
            scatter()
            for p in state.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        else:
            with self._partition():
                with dropout.rng(self._dropout_generator(state.step)):
                    loss = self.loss_fn(self.apply_fn(weights, image, mods), label)
                loss.backward()
            scatter()
            if self._sp_top is not None:
                # a leaf this rank's slab did not reach (a window bias on a rank
                # without window rows) still takes part in the line's all-reduce
                for p in state.params.values():
                    if p.grad is None and p.requires_grad:
                        p.grad = torch.zeros_like(p)
        return loss.detach(), {n: p.grad for n, p in state.params.items()}

    def train_step(self, state: TrainState, batch: Mapping):
        """One micro-step: loss, backward into the f32 masters, and one
        optimizer update (with accumulation, the update of a full window).
        Under data parallelism the gradients (or the window's mean) and the
        loss are averaged over the "data" line first; under pipeline
        parallelism summed over the pipeline line too.  Returns (the same state,
        advanced, and the loss as a 0-d tensor on the device)."""
        loss, _ = self.value_and_grad(state, batch)
        params = [] if state.accumulation is not None else [
            p for g in state.optimizer.param_groups for p in g["params"]]
        self._reduce_grads([p.grad for p in params], params, extra=[loss])
        if state.accumulation is None:
            state.optimizer.step()
        else:
            state.accumulation.step(state.optimizer)
        state.step += 1
        return state, loss

    def flush_accumulation(self, state: TrainState) -> TrainState:
        """Apply a part-filled accumulation window (the epoch's last
        micro-batches); nothing without accumulation or with an empty
        window."""
        if state.accumulation is not None:
            state.accumulation.flush(state.optimizer)
        return state

    # --------------------------------------------------------------- eval

    def evaluate(self, loader, state: TrainState, *, prefix: str = "val",
                 compute_surface: bool = False, epoch: int | None = None) -> dict:
        """Constant-blend sliding-window evaluation of every volume of
        `loader` (on every rank of a mesh, each predicting its share of the
        windows, `make_inferer`): each volume's loss, its label-map Dice by
        class (and with `compute_surface` its symmetric surface distance, on
        the host), reduced over volumes, by class and by modality, under the JAX
        package's metric names; logged at `epoch` and returned."""
        cfg = self.cfg
        inferer = self.make_inferer()
        dice_rows, surf_rows, mods, losses = [], [], [], []
        with self.eval_weights(), torch.inference_mode():
            for batch in loader:
                image = self._to_device(batch["image"])
                label = torch.as_tensor(batch["label"])
                if label.ndim == 5 and label.shape[-1] == 1:
                    label = label[..., 0]
                label = self._to_device(label, torch.int32)
                modality = batch.get("modality")
                mod_t = self._to_device(modality, torch.int32) if modality is not None else None
                logits = inferer(image, mod_t)
                self.history["eval_windows"].append(
                    inferer.windows_predicted(tuple(image.shape[1:-1])) * image.shape[0])
                losses.extend(self.loss_fn(logits[i:i + 1], label[i:i + 1])
                              for i in range(logits.shape[0]))
                pred = logits.argmax(dim=-1)
                dice_rows.append(dice_score_labels(pred, label, cfg.out_channels))
                if modality is not None:
                    mods.append(np.asarray(modality).reshape(-1))
                if compute_surface:
                    t0 = time.perf_counter()
                    classes = np.arange(cfg.out_channels)
                    pred_np = pred.cpu().numpy()[..., None] == classes
                    lab_np = label.cpu().numpy()[..., None] == classes
                    surf_rows.append(surface_distance(
                        pred_np, lab_np, include_background=cfg.include_background))
                    self.history["surface_s"].append(time.perf_counter() - t0)
            losses = torch.stack(losses).double().cpu().numpy()
            dice_all = torch.cat(dice_rows).cpu().numpy()

        vol_accs = np.asarray([float(np.nanmean(row)) for row in dice_all])
        per_class, not_nans = reduce_mean_batch(dice_all)
        metrics = {f"{prefix}/loss/avg": float(np.mean(losses)),
                   f"{prefix}/accuracy/avg": float(np.mean(vol_accs))}
        for c, v in enumerate(per_class.tolist()):
            metrics[f"{prefix}/accuracy/class_{c}"] = v
            metrics[f"{prefix}_total_dice/class{c}"] = v
        metrics[f"{prefix}_total_dice/avg"] = nanmean_valid(per_class, not_nans)
        if mods:
            mod_all = np.concatenate(mods)
            metrics.update(metric_by_modality(dice_all, mod_all, "dice", ns=prefix))
            for m in np.unique(mod_all):
                sel = mod_all == m
                metrics[f"{prefix}/accuracy/modality_{int(m)}"] = float(np.nanmean(vol_accs[sel]))
                metrics[f"{prefix}/loss/modality_{int(m)}"] = float(np.nanmean(losses[sel]))
        if compute_surface:
            surf_all = np.concatenate(surf_rows, axis=0)
            sc, sn = reduce_mean_batch(surf_all)
            off = int(not cfg.include_background)
            for c, v in enumerate(sc.tolist()):
                metrics[f"{prefix}_total_surface_distance/class{c + off}"] = v
            metrics[f"{prefix}_total_surface_distance/avg"] = nanmean_valid(sc, sn)
            if mods:
                metrics.update(metric_by_modality(surf_all, np.concatenate(mods),
                                                  "surface_distance", off, ns=prefix))
        self.logger.log(metrics, step=epoch)
        return metrics

    # ---------------------------------------------------------------- fit

    def fit(self, data, *, state: TrainState | None = None,
            report_callback: Callable[[int, float], bool] | None = None) -> TrainState:
        """A training run over `data` (a `MultiModalData`): per epoch the
        schedule's lr, the train loader's micro-steps (an lr record every
        `log_every_n_steps`), the accumulation tail, and every
        `check_val_every_n_epoch` epochs a validation that steps a plateau
        schedule, saves the top-k, `best.ckpt` and `last.ckpt` and may stop
        early (or `report_callback(epoch, acc)` may prune).  With
        `cfg.ckpt_path` the run resumes there: parameters, optimizer state,
        step counter (and with it the dropout stream), epoch and plateau
        state."""
        cfg = self.cfg
        t0 = time.perf_counter()
        train_loader = data.train_dataloader()
        val_loader = data.val_dataloader()
        self.history["setup_s"].append(time.perf_counter() - t0)
        if state is None:
            state = self.fresh_state()
        start_epoch = 0
        if cfg.ckpt_path:
            ck = load_checkpoint(cfg.ckpt_path)
            state = self.restore(state, ck)
            start_epoch = int(ck.get("epoch", 0)) + 1
            if ck.get("scheduler") and hasattr(self.scheduler, "plateau"):
                self.scheduler.plateau.load_state_dict(ck["scheduler"])

        writer = parallel.is_writer()
        ckpt = CheckpointManager(os.path.join(self.workdir, "checkpoints"),
                                 monitor="val/accuracy/avg", mode="max",
                                 save_top_k=cfg.save_top_k)
        early = EarlyStopping(patience=cfg.patience, min_delta=cfg.min_delta)
        best_acc = -np.inf
        on_card = self.device.type == "cuda"
        global_step = state.step
        for epoch in range(start_epoch, cfg.max_epochs):
            if cfg.scheduler != "reduce_on_plateau":
                set_learning_rate(state.optimizer, self.scheduler(epoch))
            epoch_lr = current_learning_rate(state.optimizer)
            train_loader.set_epoch(epoch)
            t0 = time.time()
            epoch_losses, events = [], []
            trace_dir = cfg.profile_dir if epoch == start_epoch + 1 else None
            with profile_trace(trace_dir):
                batches = iter(train_loader)
                while True:
                    tw = time.perf_counter()
                    batch = next(batches, None)
                    if batch is None:
                        break
                    self.history["loader_wait_s"].append(time.perf_counter() - tw)
                    if global_step % max(1, cfg.log_every_n_steps) == 0:
                        self.logger.log({"Charts/lr_step": epoch_lr}, step=global_step)
                    if on_card:
                        events.append((torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True)))
                        events[-1][0].record()
                    state, loss = self.train_step(state, batch)
                    if on_card:
                        events[-1][1].record()
                    epoch_losses.append(loss)
                    global_step += 1
            state = self.flush_accumulation(state)
            train_loss = (float(np.mean(torch.stack(epoch_losses).double().cpu().numpy()))
                          if epoch_losses else float("nan"))
            self.history["step_ms"].extend(a.elapsed_time(b) for a, b in events)
            self.history["epoch_s"].append(time.time() - t0)
            self.logger.log({"train/loss": train_loss, "epoch_time_s": time.time() - t0,
                             "Charts/lr": current_learning_rate(state.optimizer)}, step=epoch)

            if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                tv = time.perf_counter()
                metrics = self.evaluate(val_loader, state, epoch=epoch)
                self.history["val_s"].append(time.perf_counter() - tv)
                acc = metrics["val/accuracy/avg"]
                if cfg.scheduler == "reduce_on_plateau":
                    set_learning_rate(state.optimizer,
                                      self.scheduler(epoch, metrics["val/loss/avg"]))
                sched_state = (self.scheduler.plateau.state_dict()
                               if hasattr(self.scheduler, "plateau") else None)
                tc = time.perf_counter()
                improved = acc > best_acc
                if improved:
                    best_acc = acc
                # gathered to rank 0 when sharded (None on the other ranks)
                opt_state = self.opt_state(state, dst=0)
                weights = self.state_dict(state, dst=0)
                if writer:
                    ckpt.save(acc, params=weights, opt_state=opt_state, epoch=epoch,
                              scheduler_state=sched_state)
                    if improved:
                        save_checkpoint(os.path.join(self.workdir, "best.ckpt"),
                                        params=weights, opt_state=opt_state, epoch=epoch,
                                        best_acc=acc, scheduler_state=sched_state)
                    save_checkpoint(os.path.join(self.workdir, "last.ckpt"),
                                    params=weights, opt_state=opt_state, epoch=epoch,
                                    best_acc=best_acc, scheduler_state=sched_state)
                parallel.barrier()   # the other ranks read what rank 0 wrote only after it
                self.history["ckpt_s"].append(time.perf_counter() - tc)
                if report_callback is not None and report_callback(epoch, acc):
                    break
                if early.update(acc):
                    self.logger.log({"early_stop_epoch": epoch}, step=epoch)
                    break
        return state
