"""Pipeline parallelism: a GPipe schedule over the ranks of one line of a
mesh's pipeline axis (counterpart of `miseg_tpu/parallel/pipeline.py`).

The JAX package runs GPipe as one SPMD program: stage-stacked parameters
sharded over "pp", a `lax.scan` of ticks moving activations with
`ppermute`, and `jax.grad` through the scan for the backward.  The port
runs torch's idiom instead, one process a stage:

  * Rank s of the line is stage s and runs its own modules on the whole
    model's replicated parameters; nothing is stacked, and each boundary
    carries its real shape (no flat buffer padded to the largest stage).
  * The batch splits into M microbatches (`microbatches` must divide it,
    else `ValueError`, as JAX's :121-123).  Stage s takes microbatch i
    from stage s - 1, runs it, and sends its output on with a send that
    does not block, so stage s runs microbatch i while stage s + 1 runs
    i - 1: the bubble is (S - 1) / (M + S - 1) of the schedule, as JAX's.
  * A stage's taps (tensors the last stage needs besides the activation,
    `aux`) go to the last stage beside it.  On the last stage the
    microbatches' inputs, outputs and taps come back concatenated over
    the batch, in the autograd graph.
  * Each received tensor is detached and requires grad, and the schedule
    keeps each microbatch's (received, sent) tensors.  The backward is an
    explicit schedule (`Schedule.backward`), never autograd's node order:
    after the last stage's own backward (the caller's `loss.backward()`),
    each rank takes the microbatches in reverse order, receives its sent
    tensors' cotangents, runs `torch.autograd.backward` on them, and
    sends its received tensors' gradients back where they came from.
    Stage 0's input is detached too, and backpropagated once at the end.
  * Every rank's messages follow one global order: per microbatch, the
    activations stage by stage along the line, then the taps to the last
    stage in stage order; the backward runs that order exactly reversed.
    NCCL runs a rank's messages one after another on its communicator, a
    send waiting for its receiver, so an order that is merely the same
    on both ends of each pair can still wait in a cycle (the backward that
    returned the cotangents in the forward's order hung four H100s).
  * The receiver allocates the shape and dtype it expects; a stage whose
    output is not that raises `ValueError` before anything is sent (JAX's
    stage-shape check, :162-166).
  * Over NCCL device tensors go as they are.  A gloo group (the CPU, or
    ranks sharing one card) sends a CUDA tensor through pinned host memory:
    gloo's send and recv move host memory only.
  * `dist.isend`/`recv` take global ranks: the line's are `Mesh.line`.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layers of `stage` when `n_layers` split into `n_stages` equal
    stages (JAX's `stack_stages` rule, :50): `ValueError` unless the
    stages divide the layers."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _cat(parts: list[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _expect(t: torch.Tensor, shape: tuple, dtype: torch.dtype, what: str) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{what} is {tuple(t.shape)} {t.dtype}; its receiver expects "
                         f"{shape} {dtype}")


class Schedule:
    """One GPipe step on this rank of a pipeline line: `run` its stage's
    forward over the microbatches, then `backward` (after the caller's own
    backward on the last stage)."""

    def __init__(self, mesh, axis: str = "pp", microbatches: int = 2):
        m = int(microbatches)
        if m < 1:
            raise ValueError("microbatches must be >= 1")
        self.microbatches = m
        self.stage, self.stages = mesh.index(axis), mesh.size(axis)
        self.last = self.stage == self.stages - 1
        self._ranks = mesh.line(axis)
        self._group = mesh.group(axis)
        self._records: list = []   # per microbatch: ([(received, src)], [(sent, dst)])
        self._head = None          # stage 0: (its input, the detached copy it runs on)
        self._pending: list = []   # (work, tensor) of sends not yet waited on

    # ------------------------------------------------------------ messages

    def _staged(self, device: torch.device) -> bool:
        return device.type != "cpu" and dist.get_backend(self._group) == dist.Backend.GLOO

    def _send(self, t: torch.Tensor, stage: int) -> None:
        t = t.detach().contiguous()
        if self._staged(t.device):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = host.copy_(t)
        self._pending.append((dist.isend(t, self._ranks[stage], group=self._group), t))

    def _recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        staged = self._staged(device)
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device,
                          pin_memory=staged)
        dist.recv(buf, self._ranks[stage], group=self._group)
        return buf.to(device, non_blocking=True) if staged else buf

    def _drain(self) -> None:
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()

    # ------------------------------------------------------------ schedule

    def run(self, stage_fn: Callable, x: torch.Tensor | None, extra: Sequence, *,
            like: torch.Tensor, shapes: Sequence[tuple],
            aux: Sequence[Sequence[tuple]] | None = None):
        """This rank's stage over the microbatches.  `x`: stage 0's input
        `[B, *shapes[0]]` (None elsewhere); `extra`: per-sample side inputs
        every rank holds (sliced per microbatch, never sent; None passes
        through); `like`: a tensor every rank holds whose batch, dtype and
        device the activations share; `shapes[s]`: per-sample shape of
        stage s's input, `shapes[S]` that of the last stage's output;
        `aux[s]`: per-sample shapes of stage s's taps.  `stage_fn(h,
        *extra_mb)` returns the stage's output, and given `aux` a pair
        (output, [taps]).  Returns on the last stage (its inputs `[B, ...]`,
        its output `[B, ...]`, the taps by stage and position `[B, ...]`),
        None on the others."""
        S, s, m = self.stages, self.stage, self.microbatches
        batch, dtype, device = like.shape[0], like.dtype, like.device
        if batch % m:
            raise ValueError(f"batch {batch} not divisible by {m} microbatches")
        mb = batch // m
        taps_of = [[] for _ in range(S)] if aux is None else [list(a) for a in aux]
        if len(taps_of) != S:
            raise ValueError(f"taps of {len(taps_of)} stages for {S} stages")
        grad = torch.is_grad_enabled()

        def received(shape, src, record):
            t = self._recv((mb, *shape), dtype, device, src)
            if grad:
                t.requires_grad_()
                record.append((t, src))
            return t

        if s == 0:
            h0 = x.detach().requires_grad_(grad and x.requires_grad)
            self._head = (x, h0)
        ins, outs, taps = [], [], [[[] for _ in t] for t in taps_of]
        for i in range(m):
            rows = slice(i * mb, (i + 1) * mb)
            got, sent = [], []
            h = h0[rows] if s == 0 else received(shapes[s], s - 1, got)
            if self.last:
                for r in range(S - 1):
                    for k, shape in enumerate(taps_of[r]):
                        taps[r][k].append(received(shape, r, got))
            y = stage_fn(h, *(None if e is None else e[rows] for e in extra))
            y, mine = (y, []) if aux is None else y
            _expect(y, (mb, *shapes[s + 1]), dtype, f"stage {s}'s output")
            if len(mine) != len(taps_of[s]):
                raise ValueError(f"stage {s} returned {len(mine)} taps; its receiver "
                                 f"expects {len(taps_of[s])}")
            for k, (t, shape) in enumerate(zip(mine, taps_of[s])):
                _expect(t, (mb, *shape), dtype, f"stage {s}'s tap {k}")
            if self.last:
                for k, t in enumerate(mine):
                    taps[s][k].append(t)
            else:
                for t, dst in ((y, s + 1), *((t, S - 1) for t in mine)):
                    self._send(t, dst)
                    sent.append((t, dst))
            ins.append(h)
            outs.append(y)
            if grad:
                self._records.append((got, sent))
        self._drain()
        if not self.last:
            return None
        return _cat(ins), _cat(outs), [[_cat(parts) for parts in r] for r in taps]

    def backward(self) -> None:
        """The explicit backward of `run`, its messages in exactly the
        reverse order of the forward's: on every rank, the microbatches in
        reverse order: the cotangents of what it sent, last sent first,
        received from where it went and backpropagated
        (`torch.autograd.backward`), then the gradients of what it received
        (zeros where none reached it), last received first, sent back to
        where it came from; then stage 0's input, backpropagated once.  On
        the last stage call it after the loss's own backward."""
        for got, sent in reversed(self._records):
            if sent:
                pairs = [(t, self._recv(t.shape, t.dtype, t.device, dst))
                         for t, dst in reversed(sent)]
                pairs = [(t, g) for t, g in pairs if t.requires_grad]
                if pairs:
                    torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
            for t, src in reversed(got):
                self._send(t.grad if t.grad is not None else torch.zeros_like(t), src)
        if self._head is not None:
            x, h0 = self._head
            if x.requires_grad and h0.grad is not None:
                torch.autograd.backward(x, h0.grad)
        self._drain()
        self._records.clear()
        self._head = None


def pipeline_apply(stage_fn: Callable, x: torch.Tensor | None, *extra, mesh,
                   axis: str = "pp", microbatches: int, like: torch.Tensor,
                   shape: tuple, with_aux: bool = False, aux: Sequence[int] = ()):
    """S stages of one activation shape over this rank's pipeline line,
    GPipe-scheduled (JAX's :75, a homogeneous stack such as ViT's blocks).

    Each rank runs `stage_fn(h, *extra_mb)` for its own stage on `[B/M,
    *shape]` microbatches; `x [B, *shape]` is stage 0's input (None on the
    other ranks), `like` a tensor every rank holds with the batch, dtype
    and device of the activations, `extra` per-sample side inputs such as
    the modalities.  With `with_aux`, `stage_fn` returns `(h, [taps])`,
    `aux[s]` of them on stage s, each of `h`'s shape (e.g. the in-stage
    hidden states a UNETR decoder taps), sent to the last stage.

    Returns `(out, schedule)`: on the last stage `out` is the pipeline's
    output `[B, *shape]`, with `with_aux` the pair (output, taps by stage:
    `aux[s]` tensors `[B, *shape]` each), on the other ranks None; call
    `schedule.backward()` on every rank to backpropagate."""
    schedule = Schedule(mesh, axis, microbatches)
    S = schedule.stages
    taps = [[tuple(shape)] * int(n) for n in aux] if with_aux else None
    result = schedule.run(stage_fn, x, extra, like=like, shapes=[tuple(shape)] * (S + 1),
                          aux=taps)
    if result is None:
        return None, schedule
    _, y, t = result
    return ((y, t) if with_aux else y), schedule


def pipeline_apply_hetero(stage_fns: Sequence[Callable], x: torch.Tensor | None, *extra,
                          mesh, axis: str = "pp", microbatches: int, like: torch.Tensor,
                          shapes: Sequence[tuple]):
    """GPipe with stages that change the activation's shape (JAX's :190,
    e.g. swin stages whose patch merging halves the grid and doubles the
    channels): this rank runs `stage_fns[stage]`; `shapes[s]` is the
    per-sample shape of stage s's input and `shapes[S]` of the last
    output.  Returns `(ys, schedule)`: on the last stage `ys` is the output
    of every stage, `[B, *shapes[s + 1]]` for stage s (JAX's `ys[s]`: the
    taps of a pyramid decoder), on the other ranks None."""
    schedule = Schedule(mesh, axis, microbatches)
    S, s = schedule.stages, schedule.stage
    if len(stage_fns) != S:
        raise ValueError(f"{len(stage_fns)} stage_fns for a {S}-way {axis!r} mesh axis")
    shapes = [tuple(sh) for sh in shapes]
    # the outputs of stages 0..S-3 reach the last stage as taps; S-2's is its input
    aux = [[shapes[r + 1]] if r < S - 2 else [] for r in range(S)]

    def stage_fn(h, *e):
        y = stage_fns[s](h, *e)
        return y, [y] if s < S - 2 else []

    result = schedule.run(stage_fn, x, extra, like=like, shapes=shapes, aux=aux)
    if result is None:
        return None, schedule
    ins, y, taps = result
    ys = [taps[r][0] for r in range(S - 2)] + ([ins] if S > 1 else []) + [y]
    return ys, schedule
