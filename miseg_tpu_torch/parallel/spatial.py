"""Spatial partitioning (SP): shard the training PATCH, not the batch
(counterpart of `miseg_tpu/parallel/spatial.py`).

The JAX package places the patch's dim 1 (D of `[B, D, H, W, C]`, H of a
2-D `[B, H, W, C]`) on an "sp" mesh axis and lets GSPMD insert the rest:
halo exchanges around every conv, all-reduces of the instance norms'
statistics, collective permutes for the swin rolls.  Torch has no GSPMD,
so each of those is written here and called by the layers that need it,
one rank a card over the `cfg.spatial_axis` line of the mesh
(`parallel.mesh_from_config`), for every model the port builds, in 3-D
and in 2-D (below, "D" and "plane" name dim 1 of either).

  * `spatial_spec` and `shard_spatial_batch` follow JAX's placement rules:
    dim 1 on the sp coordinate, the batch on "data", a low-rank array by
    the batch rule alone, an indivisible dim whole.
  * The level rule: a level (a resolution of the network) stays sharded
    while its slab has an even number of planes, at least 2; below that a
    tensor is whole, the same on every rank of the line.  `partition`
    makes the rule active for a training forward (and its backward),
    given the top level's global D and H and the tensors' rank;
    `line_of(x)` says whether `x` is a slab (its level found by its dim 2:
    H, or W in 2-D).  An op that changes the level (a strided or
    transposed conv, patch merging, UNetVanilla's upsampling, C-UNETR's
    token volumes) computes on its input's partition and then `settle`s
    its output: gathered where the new level is whole, sliced where it is
    sharded.  A module that runs whole on every rank (C-UNETR's ViT, on
    the gathered input) runs under `suspended()`.
  * The autograd Functions that stand in for GSPMD:
    - `halo_d(x, lo, hi)`: the slab with `lo` planes of the lower and
      `hi` of the upper neighbour around it (zeros past the volume), by
      one all-gather of every rank's edge planes; its backward all-gathers
      the halo planes' cotangents and each rank adds its neighbours' to
      the planes they came from.  Collectives, not P2P: NCCL serialises a
      rank's P2P messages and gloo's P2P of a CUDA tensor kills the sender
      (ROADMAP D6).
    - `gather_d` / `slice_d`: slab to whole and back; `gather_d`'s backward
      is a reduce-scatter by sum (gloo, which has none: an all-reduce and
      the rank's slab), `slice_d`'s a zero-filled whole cotangent.
    - `gather_rows`: the swin blocks' window rows, shared unevenly, to
      every rank; its backward sums the cotangents over the line and
      keeps the rank's rows.
    - `merge_moments`: each rank's per-(sample, channel) (mean, M2)
      all-gathered and merged by Chan's formula (W1, D3) in rank order,
      so every rank holds the same bits; its backward all-reduces the
      cotangents, as `mesh._GlobalBatchStats` does.
    - `sum_over_line`: an all-reduce whose backward is the identity (the
      losses' per-(sample, class) sums).
  * The gradient rule (`Trainer._reduce_grads`): every rank's loss is the
    whole patch's, and the backward of the pieces above leaves on each
    rank its slab's part of every gradient (of a tensor every rank holds
    whole, a share whose sum over the line is the whole), so one
    all-reduce over every rank sums the line and divides by the "data"
    size (D5's `all_reduce_mean(..., over=)`), and every rank keeps
    bitwise-equal masters.  A top level that the rule leaves whole (D
    indivisible by the line, or an odd slab) runs replicated: every rank
    computes the whole step and the sum is divided by the line's size too.
  * Beside FSDP (JAX composes the two "by pointing `fsdp_axis` at either"
    axis) each sharded leaf is gathered whole once a step as without SP,
    and its gradient is still counted once: on the spatial line the
    reduce-scatter after the backward sums the slabs' parts (for a whole
    patch, whose ranks hold one gradient, it takes the rank's piece),
    then the "data" mean; on "data" the reduce-scatter takes the "data"
    mean, then the spatial line sums the slabs' parts (averages a whole
    patch's copies).  The replicated leaves keep the rule above
    (`Trainer._reduce_grads`, `fsdp.gather_for_step`).

  * Beside tensor parallelism the ranks of a "model" line share this
    rank's slab, so Megatron's all-reduces run on it; beside the pipeline
    each (data, spatial) coordinate runs its own line and the pieces
    above run among the ranks of one stage's spatial line
    (`models/*_pp.py`, ROADMAP D13).

SP is training-only, as in JAX: validation and test run the whole model
on whole weights, their window groups fanned out over the mesh's first
axis (`inferers.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..ops.kernels import fused_conv, fused_norm

SPATIAL_DIM = 1  # D of [B, D, H, W, C] / [B, D, H, W]; H of [B, H, W, C] / [B, H, W]
# collectives launched by the functions below, forward and backward, by
# kind, since the caller last set them to 0
collectives = dict.fromkeys(("halo", "gather", "rows", "merge", "sum"), 0)


# ------------------------------------------------------------ placement

def spatial_spec(ndim: int, data_axis: str | None, spatial_axis: str) -> tuple:
    """The placement of an image-like array as JAX's PartitionSpec entries:
    the batch dim on `data_axis` (if given), dim 1 on `spatial_axis`, the
    rest whole; trailing Nones stripped."""
    spec = [None] * ndim
    if ndim > 0 and data_axis is not None:
        spec[0] = data_axis
    if ndim > SPATIAL_DIM + 1:  # rank >= 3: has true spatial extent
        spec[SPATIAL_DIM] = spatial_axis
    return _canon(spec)


def _canon(spec: list) -> tuple:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def placement(shape, mesh, spatial_axis: str = "sp", data_axis: str | None = "data") -> tuple:
    """JAX's `shard_spatial_batch` rule for one array of `shape` on `mesh`:
    dim 0 on "data" when the mesh has it (more than one rank) and the batch
    divides, dim 1 on the spatial axis when the array has rank >= 3 and D
    divides; else whole, dim by dim."""
    n_sp = mesh.size(spatial_axis)
    n_dp = mesh.size(data_axis) if data_axis else 1
    ndim = len(shape)
    if ndim == 0:
        return ()
    spec = [None] * ndim
    spec[0] = data_axis if (n_dp > 1 and shape[0] % n_dp == 0) else None
    if n_sp > 1 and ndim > SPATIAL_DIM + 1 and shape[SPATIAL_DIM] % n_sp == 0:
        spec[SPATIAL_DIM] = spatial_axis
    return _canon(spec)


def shard_spatial_batch(batch: dict, mesh, spatial_axis: str = "sp",
                        data_axis: str | None = "data") -> dict:
    """This rank's piece of a batch dict by `placement`: image `[B, D, H,
    W, C]` and label `[B, D, H, W]` cut on dim 0 by the "data" coordinate
    and on D by the spatial one, a low-rank array (modality `[B]`) by the
    batch rule alone; what does not divide stays whole.  Non-arrays pass."""
    def piece(x):
        if not hasattr(x, "shape"):
            return x
        spec = placement(tuple(x.shape), mesh, spatial_axis, data_axis)
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = x.shape[dim] // mesh.size(axis)
                x = x[(slice(None),) * dim + (slice(mesh.index(axis) * n,
                                                     (mesh.index(axis) + 1) * n),)]
        return x

    return {k: piece(v) for k, v in batch.items()}


# ----------------------------------------------------------- the line

@dataclasses.dataclass(frozen=True)
class Line:
    """The active partition: the sp line's process group, size and this
    rank's coordinate, the top level's global D and H, and the rank of
    the network's image-like tensors (5 for `[B, D, H, W, C]`; 4 in 2-D,
    where the slab dim is H and the level is found by W)."""
    group: object
    size: int
    index: int
    depth: int
    height: int
    ndim: int = 5

    @property
    def low_edge(self) -> bool:
        """The rank's slab starts at the volume's first plane."""
        return self.index == 0

    @property
    def high_edge(self) -> bool:
        """The rank's slab ends at the volume's last plane."""
        return self.index == self.size - 1


# module state, not context variables: the backward (and a block's
# recompute inside it, `nn/recompute.py`) may run on autograd's device
# thread, which sees no context variable of the caller's
_line: Line | None = None
_rows: tuple | None = None


def sharded_depth(depth: int, size: int) -> bool:
    """The level rule: a level of global depth `depth` is sharded over a line
    of `size` ranks while its slab has an even number of planes, >= 2."""
    return size > 1 and depth > 0 and depth % (2 * size) == 0


@contextlib.contextmanager
def partition(group, size: int, index: int, depth: int, height: int, ndim: int = 5):
    """Inside this block the level rule is active over the line (`group`,
    `size`, this rank's `index`) for a network whose top level has global
    depth `depth` and height `height` (dims 1 and 2 of its `ndim`-rank
    tensors); the block's tensors of a sharded level are this rank's
    slabs of dim 1."""
    global _line
    outer, _line = _line, Line(group, size, index, depth, height, ndim)
    try:
        yield
    finally:
        _line = outer


@contextlib.contextmanager
def suspended():
    """Inside this block no partition is active: a module that runs whole
    on every rank (C-UNETR's ViT, on the gathered input) sees whole
    tensors as one process does."""
    global _line
    outer, _line = _line, None
    try:
        yield
    finally:
        _line = outer


def active() -> Line | None:
    """The active partition, or None."""
    return _line


def level_depth(line: Line, height: int) -> int:
    """The global D of the level whose tensors have H = `height`: the top
    level's D halved (rounded up) as often as its H is."""
    h, d = line.height, line.depth
    while h > height:
        h, d = -(-h // 2), -(-d // 2)
    if h != height:
        raise ValueError(f"spatial partitioning: no level has H = {height} "
                         f"(top level H {line.height})")
    return d


def line_of(x: torch.Tensor) -> Line | None:
    """The active line when `x` (`[B, D, H, W, C]`, or `[B, H, W, C]` in
    2-D) is a slab of a sharded level, else None (no active partition, a
    tensor of another number of dims than the line's `ndim`, or a whole
    level)."""
    line = _line
    if line is None or x.ndim != line.ndim:
        return None
    depth = level_depth(line, x.shape[2])
    if not sharded_depth(depth, line.size):
        return None
    if x.shape[SPATIAL_DIM] != depth // line.size:
        raise RuntimeError(f"spatial partitioning: a tensor of the level of D {depth} has "
                           f"{x.shape[SPATIAL_DIM]} planes, not its slab's "
                           f"{depth // line.size}")
    return line


def global_dims(x: torch.Tensor) -> tuple[int, ...]:
    """The spatial dims of the whole volume that `x` belongs to."""
    dims = tuple(x.shape[1:-1])
    line = line_of(x)
    return dims if line is None else (dims[0] * line.size, *dims[1:])


def local_dims(dims: tuple[int, ...]) -> tuple[int, ...]:
    """This rank's spatial dims of a level whose whole volume has `dims`:
    its slab's where the active line shards the level, else `dims`."""
    line = _line
    if line is None or not sharded_depth(dims[0], line.size):
        return dims
    return (dims[0] // line.size, *dims[1:])


def settle(y: torch.Tensor, was_slab: bool) -> torch.Tensor:
    """`y`, computed on the partition of an input that was a slab
    (`was_slab`) or whole, in the state of its own level: gathered where
    that level is whole, sliced where it is sharded."""
    line = _line
    if line is None or y.ndim != line.ndim:
        return y
    sharded = sharded_depth(level_depth(line, y.shape[2]), line.size)
    if was_slab and not sharded:
        return gather_d(y, line)
    if sharded and not was_slab:
        return slice_d(y, line)
    return y


def window_rows(n_rows: int, line: Line) -> tuple[int, int, list[int]]:
    """(first, end) of this rank's share of `n_rows` window rows along D,
    and every rank's count: the first `n_rows % size` ranks one more."""
    base, extra = divmod(n_rows, line.size)
    counts = [base + (r < extra) for r in range(line.size)]
    first = sum(counts[:line.index])
    return first, first + counts[line.index], counts


@contextlib.contextmanager
def rows(batch: int, n_rows: int, per_row: int, first: int, end: int):
    """Inside this block, tensors whose leading extent is `batch * (end -
    first) * per_row` hold rows [first, end) of the `n_rows` window rows
    (of `per_row` windows each) of every sample: their dropout masks are
    those rows of the whole windows' mask."""
    global _rows
    outer, _rows = _rows, (batch, n_rows, per_row, first, end)
    try:
        yield
    finally:
        _rows = outer


def mask_part(x: torch.Tensor, shape: tuple):
    """(the shape of the whole mask that an element-wise dropout of `x`
    draws a slice of, the function that takes the slice) under spatial
    partitioning: a slab's mask is its D slab of the whole volume's, the
    window rows' mask those rows of all windows'; else (shape, None)."""
    if tuple(shape) != tuple(x.shape):
        return shape, None   # drop-path: one draw a sample, the same on every rank
    rows_ = _rows
    if rows_ is not None:
        b, n_rows, per, first, end = rows_
        if x.shape[0] == b * (end - first) * per:
            def take(m):
                return m.reshape(b, n_rows, per, *m.shape[1:])[:, first:end].reshape(
                    -1, *m.shape[1:])
            return (b * n_rows * per, *shape[1:]), take
    line = line_of(x)
    if line is None:
        return shape, None
    d = x.shape[SPATIAL_DIM]
    return ((shape[0], d * line.size, *shape[2:]),
            lambda m: m.narrow(SPATIAL_DIM, line.index * d, d))


# ----------------------------------------------------------- collectives

def _count(kind: str) -> None:
    collectives[kind] += 1


def _gather(t: torch.Tensor, line: Line) -> list[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(line.size)]
    dist.all_gather(parts, t.contiguous(), group=line.group)
    return parts


class _HaloD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, line):
        ctx.lo, ctx.hi, ctx.line = lo, hi, line
        d = x.shape[SPATIAL_DIM]
        # the planes the upper neighbour takes (my last lo) and the lower one (my first hi)
        edges = torch.cat([x.narrow(1, d - lo, lo), x.narrow(1, 0, hi)], 1)
        parts = _gather(edges, line)
        _count("halo")
        r = line.index
        low = (parts[r - 1].narrow(1, 0, lo) if r > 0 else x.new_zeros(
            (x.shape[0], lo, *x.shape[2:])))
        high = (parts[r + 1].narrow(1, lo, hi) if r < line.size - 1 else x.new_zeros(
            (x.shape[0], hi, *x.shape[2:])))
        return torch.cat([low, x, high], 1)

    @staticmethod
    def backward(ctx, g):
        lo, hi, line = ctx.lo, ctx.hi, ctx.line
        d = g.shape[SPATIAL_DIM] - lo - hi
        dx = g.narrow(1, lo, d).clone()
        # my low halo's cotangent goes to the lower neighbour's last lo
        # planes, my high halo's to the upper neighbour's first hi planes
        parts = _gather(torch.cat([g.narrow(1, 0, lo), g.narrow(1, lo + d, hi)], 1), line)
        _count("halo")
        r = line.index
        if r < line.size - 1 and lo:
            dx.narrow(1, d - lo, lo).add_(parts[r + 1].narrow(1, 0, lo))
        if r > 0 and hi:
            dx.narrow(1, 0, hi).add_(parts[r - 1].narrow(1, lo, hi))
        return dx, None, None, None


def halo_d(x: torch.Tensor, lo: int, hi: int, line: Line) -> torch.Tensor:
    """The slab `x` with `lo` planes of the lower neighbour's slab before it
    and `hi` of the upper one's after it (zeros past the volume's ends);
    `hi` < 0 drops the slab's last -hi planes.  Differentiable."""
    d = x.shape[SPATIAL_DIM]
    if max(lo, hi) > d:
        raise ValueError(f"halo of {lo}/{hi} planes around a slab of {d}")
    y = x if lo == max(hi, 0) == 0 else _HaloD.apply(x, lo, max(hi, 0), line)
    return y if hi >= 0 else y.narrow(1, 0, lo + d + hi)


def _reduce_scatter_d(g: torch.Tensor, line: Line) -> torch.Tensor:
    """The sum over the line of `g` (whole along D), this rank's slab."""
    d = g.shape[SPATIAL_DIM] // line.size
    _count("gather")
    if dist.get_backend(line.group) == dist.Backend.NCCL:
        whole = g.movedim(1, 0).contiguous()
        mine = whole.new_empty((d, *whole.shape[1:]))
        dist.reduce_scatter_tensor(mine, whole, group=line.group)
        return mine.movedim(0, 1).contiguous()
    whole = g.contiguous().clone()
    dist.all_reduce(whole, group=line.group)
    return whole.narrow(1, line.index * d, d).contiguous()


class _GatherD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        _count("gather")
        return torch.cat(_gather(x, line), 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_d(g, ctx.line), None


def gather_d(x: torch.Tensor, line: Line) -> torch.Tensor:
    """The whole volume of which `x` is this rank's D slab, on every rank
    (one all-gather; backward: a reduce-scatter by sum)."""
    return _GatherD.apply(x, line)


def slice_d(x: torch.Tensor, line: Line) -> torch.Tensor:
    """This rank's D slab of the whole `x`, contiguous, as the kernels take
    it (backward: the slab's cotangent in a zero-filled whole)."""
    d = x.shape[SPATIAL_DIM] // line.size
    return x.narrow(1, line.index * d, d).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts, line):
        ctx.counts, ctx.line = counts, line
        most = max(counts)
        pad = x.new_zeros((x.shape[0], most - x.shape[1], *x.shape[2:]))
        parts = _gather(torch.cat([x, pad], 1), line)
        _count("rows")
        return torch.cat([p.narrow(1, 0, n) for p, n in zip(parts, counts)], 1)

    @staticmethod
    def backward(ctx, g):
        counts, line = ctx.counts, ctx.line
        whole = g.contiguous().clone()
        dist.all_reduce(whole, group=line.group)
        _count("rows")
        return whole.narrow(1, sum(counts[:line.index]), counts[line.index]), None, None


def gather_rows(x: torch.Tensor, counts: list[int], line: Line) -> torch.Tensor:
    """Every rank's rows (dim 1; rank r holds `counts[r]` of them, padded
    to the most for the all-gather and trimmed) in rank order, on every
    rank; backward: the cotangent summed over the line, this rank's rows."""
    return _GatherRows.apply(x, counts, line)


class _MergeMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, m2, n, line):
        parts = torch.stack(_gather(torch.stack([mean, m2]), line))
        _count("merge")
        means, m2s = parts[:, 0], parts[:, 1]                  # [R, B, C]
        g_mean = means.sum(0) / line.size                      # equal counts a rank
        g_m2 = m2s.sum(0) + n * (means - g_mean).square().sum(0)
        ctx.save_for_backward(mean - g_mean)
        ctx.n, ctx.line = n, line
        return g_mean, g_m2

    @staticmethod
    def backward(ctx, d_mean, d_m2):
        (dev,) = ctx.saved_tensors
        zero = torch.zeros_like(dev)
        g = torch.stack([zero if d_mean is None else d_mean, zero if d_m2 is None else d_m2])
        dist.all_reduce(g, group=ctx.line.group)
        _count("merge")
        # d(merged mean)/d(mean_r) = 1 / R; d(merged M2)/d(mean_r) =
        # 2 n (mean_r - mean); d(merged M2)/d(M2_r) = 1
        return g[0] / ctx.line.size + 2.0 * ctx.n * dev * g[1], g[1], None, None


def merge_moments(n: int, mean: torch.Tensor, m2: torch.Tensor,
                  line: Line) -> tuple[int, torch.Tensor, torch.Tensor]:
    """The line's (count, mean, M2) from each rank's `n` elements' (mean,
    M2) of any shape (`[B, C]`, f32): all-gathered and merged by Chan's
    formula in rank order, the same bits on every rank.  Differentiable
    (backward: the cotangents all-reduced)."""
    g_mean, g_m2 = _MergeMoments.apply(mean, m2, n, line)
    return n * line.size, g_mean, g_m2


class _SumOverLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, line):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=line.group)
        _count("sum")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_line(t: torch.Tensor, line: Line) -> torch.Tensor:
    """The sum over the line of every rank's `t`, on every rank; its
    backward is the identity: each rank's loss is the whole patch's, so the
    cotangent of the sum is the cotangent of each rank's own term."""
    return _SumOverLine.apply(t, line)


def line_sum(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` (a sum over `like`'s spatial dims) summed over the line when
    `like` is a slab, else `t`."""
    line = line_of(like)
    return t if line is None else sum_over_line(t, line)


def line_mean(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The mean of `t` (elements a voxel of `like`'s slab) over the whole
    volume when `like` is a slab, else `t.mean()`."""
    line = line_of(like)
    if line is None:
        return t.mean()
    return sum_over_line(t.sum(), line) / (t.numel() * line.size)


# -------------------------------------------------------- layers' pieces

def instance_columns(x: torch.Tensor, gamma=None, beta=None, styles=None, *,
                     eps: float = 1e-5):
    """Instance-norm columns f32 (scale, shift) `[B, C]` of `x` `[B, *S,
    C]`: K1 (`channel_scale_shift`), or for a slab K1's moments mode, the
    line's `merge_moments`, and the fold on the `[B, C]` moments."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
    line = line_of(x)
    if line is None:
        return fused_norm.channel_scale_shift(x3, gamma, beta, styles, eps=eps)
    mean, m2 = fused_norm.channel_moments(x3)
    n, mean, m2 = merge_moments(x3.shape[1], mean, m2, line)
    return fused_norm.columns_from_moments(n, mean, m2, gamma, beta, styles, eps=eps)


def instance_norm_act(x: torch.Tensor, gamma=None, beta=None, styles=None, *,
                      eps: float = 1e-5, negative_slope: float | None = None, add=None):
    """`fused_norm.instance_norm_act` (K1 then K2) with the statistics of
    the whole volume when `x` is a slab (`instance_columns`)."""
    if line_of(x) is None:
        return fused_norm.instance_norm_act(x, gamma, beta, styles, eps=eps,
                                            negative_slope=negative_slope, add=add)
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1]).contiguous()
    scale, shift = instance_columns(x, gamma, beta, styles, eps=eps)
    add3 = add.reshape(x3.shape).contiguous() if add is not None else None
    return fused_norm.apply_scale_shift(x3, scale, shift, add3,
                                        negative_slope=negative_slope).reshape(shape)


def group_norm(x: torch.Tensor, num_groups: int, gamma=None, beta=None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Group norm of the slab `x` with each (sample, group)'s statistics
    merged over the line (`ops.norms.group_norm`'s two passes, then Chan's
    merge)."""
    line = line_of(x)
    b, *spatial, c = x.shape
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    n = xg.shape[1] * xg.shape[3]
    mean = xg.mean((1, 3))
    m2 = (xg - mean[:, None, :, None]).square().sum((1, 3))
    total, mean, m2 = merge_moments(n, mean, m2, line)
    inv = torch.rsqrt((m2 / total).clamp_min(0.0) + eps)
    y = ((xg - mean[:, None, :, None]) * inv[:, None, :, None]).reshape(x.shape)
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def conv3_halo(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None, *,
               slope: float | None = None, line: Line):
    """K4's D-halo mode on the slab `x`: `halo_d` of one plane a side, the
    conv with the prologue on read (the volume's own padding planes flagged
    zero), and the output's (count, mean, M2) merged over the line."""
    xh = halo_d(x, 1, 1, line)
    y, mean, m2 = fused_conv.conv3_halo_moments(xh, w, scale, shift, slope=slope,
                                                pad_lo=line.low_edge, pad_hi=line.high_edge)
    s = y.shape[1] * y.shape[2] * y.shape[3]
    return (y, *merge_moments(s, mean, m2, line))


def conv_dims(kernel: int, stride: int, padding: int, *, transposed: bool = False):
    """(planes of the lower neighbour, of the upper one) that a conv of this
    kernel, stride and padding along D reads around a slab whose count of
    planes the stride divides (a negative upper count: the slab's last
    planes go unread); transposed, those its outputs' slab reads."""
    if transposed:
        return (kernel - 1 - padding) // stride, (padding - 1) // stride + 1
    return padding, kernel - stride - padding
