"""Sliding-window inference with overlap blending (counterpart of
`miseg_tpu/inferers.py:42-79,287-462`), over 3-D volumes or 2-D slices
(the rank is `len(roi_size)`).

Tiles a volume into fixed ROIs on a regular grid
(`scan_interval = roi * (1 - overlap)`), predicts window groups of
`sw_batch_size`, blends with a constant or gaussian importance map, and
normalizes by the summed importance.  Windows accumulate in place on the
device in a Python loop over window groups: the same math as the JAX
package's static cell-grid overlap-add, summed in another order.

Every call runs the shape's volume program (`program`), the one body
that serving also captures as a CUDA graph.  `stitch_on_host` (the
reference's `infer_cpu`, `miseg_tpu/inferers.py:464`) keeps the padded
input on the device and predicts each window group there, but puts the
importance map, the blend count and so the f32 accumulator in host
memory, each group's logits copied there; the result, `acc / count`,
comes back on the inferer's device.  The device then never holds a
`[B, *padded, C_out]` accumulator, which caps its memory on large
volumes.  `progress` prints
JAX's `\r[sliding-window] i/n` line to stderr after each window group.

Given a `mesh` (`parallel.Mesh`) whose first axis has N > 1 ranks, the
window groups fan out over this rank's line of that axis, as JAX's
`shard_map` splits them (`miseg_tpu/inferers.py:227-251`): the group list
is padded to a multiple of N by repeating its last group, each rank
predicts ⌈G/N⌉ groups, and the padded outputs are dropped.  Rank i
predicts groups i, i + N, i + 2N, ...; each round all-gathers that
round's N groups' logits over the line (`parallel.mesh.all_gather_line`)
and every rank overlap-adds them in global group order, so the logits
are one process's, bit for bit, and memory holds N groups beyond the
accumulator.  JAX gives each device a contiguous block of groups: which
rank computes which window differs, the result and the count a rank do
not.  Ranks that share a first-axis coordinate predict the same windows,
as JAX's devices do.  `stitch_on_host` has no fan-out (nor has JAX's
host stitching), and progress is off under fan-out, as in JAX.
"""

from __future__ import annotations

import itertools
import math
import sys
from typing import Callable, Sequence

import numpy as np
import torch

from .parallel.mesh import all_gather_line
from .utils.platform import resolve_device


def scan_interval(roi_size: Sequence[int], overlap: float) -> tuple[int, ...]:
    """MONAI's per-dim scan interval: int(roi * (1 - overlap)), min 1."""
    return tuple(max(1, int(r * (1.0 - overlap))) for r in roi_size)


def dense_patch_starts(image_size: Sequence[int], roi_size: Sequence[int],
                       interval: Sequence[int]) -> np.ndarray:
    """Grid of window start corners `[N, nd]` (MONAI dense_patch_slices)."""
    per_dim = []
    for size, roi, step in zip(image_size, roi_size, interval):
        if size <= roi:
            per_dim.append([0])
            continue
        n = int(math.ceil((size - roi) / step)) + 1
        starts = [min(i * step, size - roi) for i in range(n)]
        per_dim.append(list(dict.fromkeys(starts)))  # dedupe, keep order
    return np.array(list(itertools.product(*per_dim)), dtype=np.int32)


def gaussian_importance(roi_size: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Gaussian blend map centered on the ROI."""
    grids = np.meshgrid(*[np.arange(r, dtype=np.float64) for r in roi_size],
                        indexing="ij")
    out = np.zeros(tuple(roi_size), dtype=np.float64)
    for g, r in zip(grids, roi_size):
        sigma = max(r * sigma_scale, 1e-3)
        center = (r - 1) / 2.0
        out = out + (-0.5 * ((g - center) / sigma) ** 2)
    out = np.exp(out)
    out = out / out.max()
    return np.maximum(out, out.max() * 1e-3).astype(np.float32)


def _pad_to_grid(spatial: Sequence[int], roi_size: Sequence[int],
                 interval: Sequence[int]) -> tuple[int, ...]:
    """Smallest padded size >= max(spatial, roi) with (size - roi) % step == 0."""
    out = []
    for s, r, st in zip(spatial, roi_size, interval):
        s = max(s, r)
        rem = (s - r) % st
        out.append(s if rem == 0 else s + (st - rem))
    return tuple(out)


def window_starts(spatial: Sequence[int], roi_size: Sequence[int],
                  overlap: float) -> tuple[tuple[int, ...], np.ndarray]:
    """(padded shape, window start corners `[N, nd]`) that the inferer
    uses for a volume of `spatial` size."""
    interval = scan_interval(roi_size, overlap)
    padded = _pad_to_grid(spatial, roi_size, interval)
    return padded, dense_patch_starts(padded, roi_size, interval)


class SlidingWindowInferer:
    """`predict_fn(windows [k*B, *roi, Cin], modalities int[k*B] | None)
    -> logits [k*B, *roi, out_channels]`; windows are ordered window-major,
    batch-minor, and the modality vector is tiled to match.  With `mesh`
    (a `parallel.Mesh`, or None) the window groups fan out over its first
    axis: every rank of the mesh calls the inferer on the same inputs."""

    def __init__(self, predict_fn: Callable, roi_size: Sequence[int],
                 sw_batch_size: int = 1, overlap: float = 0.5,
                 mode: str = "constant", sigma_scale: float = 0.125,
                 out_channels: int | None = None, stitch_on_host: bool = False,
                 progress: bool = False, device=None, mesh=None):
        if mode not in ("constant", "gaussian"):
            raise ValueError(f"unknown blend mode {mode!r}")
        if out_channels is None:
            raise ValueError("out_channels must be set on SlidingWindowInferer")
        self.predict_fn = predict_fn
        self.roi_size = tuple(int(r) for r in roi_size)
        self.sw_batch_size = int(sw_batch_size)
        self.overlap = float(overlap)
        self.mode = mode
        self.sigma_scale = float(sigma_scale)
        self.out_channels = int(out_channels)
        self.stitch_on_host = bool(stitch_on_host)
        self.progress = bool(progress)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._tables: dict = {}  # padded shape -> (starts, importance, count)

    def _fan_out(self):
        """(process group, size, this rank's coordinate) of the line of the
        mesh's first axis that the window groups fan out over, or None: no
        mesh, a first axis of one rank, or `stitch_on_host`."""
        mesh = self.mesh
        if mesh is None or self.stitch_on_host or mesh.shape[0] < 2:
            return None
        return mesh.group(mesh.axes[0]), mesh.shape[0], mesh.coords[0]

    @staticmethod
    def _padded(n_groups: int, n: int) -> list[int]:
        """The group indices padded to a multiple of `n` by repeating the
        last (JAX's padding of its starts)."""
        return list(range(n_groups)) + [n_groups - 1] * (-n_groups % n)

    def windows_predicted(self, spatial: Sequence[int]) -> int:
        """The windows this rank predicts for a volume of `spatial` size:
        all of them, or under fan-out those of its ⌈G/N⌉ groups, padded
        repeats included."""
        n = len(window_starts(spatial, self.roi_size, self.overlap)[1])
        k = self.sw_batch_size
        sizes = [min(k, n - g) for g in range(0, n, k)]
        fan = self._fan_out()
        if fan is None:
            return n
        _, size, index = fan
        return sum(sizes[g] for g in self._padded(len(sizes), size)[index::size])

    def _importance(self) -> np.ndarray:
        if self.mode == "constant":
            return np.ones(self.roi_size, np.float32)
        return gaussian_importance(self.roi_size, self.sigma_scale)

    def _overlap_count(self, padded, starts, imp) -> np.ndarray:
        """Host-precomputed blend normalizer over the padded volume."""
        cnt = np.zeros(padded, np.float64)
        for s in starts:
            cnt[tuple(slice(a, a + r) for a, r in zip(s, self.roi_size))] += imp
        cnt[cnt == 0] = 1.0
        return cnt.astype(np.float32)

    def _blend_tables(self, spatial):
        """(padded shape, window starts, importance map and blend count on
        the device that stitches: the host with `stitch_on_host`)."""
        padded, starts = window_starts(spatial, self.roi_size, self.overlap)
        if padded not in self._tables:
            imp = self._importance()
            count = self._overlap_count(padded, starts, imp)
            where = torch.device("cpu") if self.stitch_on_host else self.device
            self._tables[padded] = (
                starts, torch.from_numpy(imp).to(where)[..., None],
                torch.from_numpy(count).to(where)[..., None])
        return padded, *self._tables[padded]

    def program(self, spatial: Sequence[int]):
        """The volume program for inputs of `spatial` size (the counterpart
        of `program`, miseg_tpu/inferers.py:362): `(fn, starts, imp,
        count)` with `fn(inputs [B, *spatial, C], modalities, imp, count)`
        -> f32 blended logits `[B, *spatial, out_channels]`, a view of the
        accumulator.  `fn` pads, gathers each window group, predicts,
        blends, normalizes and crops; the window starts are fixed by the
        shape and stay Python ints inside it, while the importance map and
        the blend count are tensors passed in, as JAX passes them as device
        arguments.  The accumulator lies where `imp` does: on the inferer's
        device, where nothing in `fn` waits for the host, so a CUDA graph
        can capture it (`serve.ServedModel`), or in host memory under
        `stitch_on_host`, each group's logits copied there.  Under fan-out
        `fn` predicts this rank's groups and all-gathers each round's
        (module docstring)."""
        spatial = tuple(int(s) for s in spatial)
        roi, out_ch, k = self.roi_size, self.out_channels, self.sw_batch_size
        padded, starts, imp, count = self._blend_tables(spatial)
        lo = [(p - s) // 2 for s, p in zip(spatial, padded)]  # symmetric pad
        hi = [p - s - l for s, p, l in zip(spatial, padded, lo)]
        pad = None
        if any(lo) or any(hi):
            pad = [0, 0]
            for a, b in zip(reversed(lo), reversed(hi)):
                pad += [a, b]
        groups = [[tuple(slice(int(a), int(a) + r) for a, r in zip(s, roi))
                   for s in starts[g:g + k]] for g in range(0, len(starts), k)]
        crop = (slice(None), *(slice(l, l + s) for l, s in zip(lo, spatial)))
        predict, fan = self.predict_fn, self._fan_out()
        progress = self.progress and fan is None
        line = 1 if fan is None else fan[1]
        ids = self._padded(len(groups), line)
        rounds = [ids[r:r + line] for r in range(0, len(ids), line)]

        def fn(inputs, modalities, imp, count):
            x = inputs if pad is None else torch.nn.functional.pad(inputs, pad)
            b = x.shape[0]
            acc = torch.zeros((b, *padded, out_ch), dtype=torch.float32, device=imp.device)

            def run(group):
                windows = torch.cat([x[(slice(None), *w)] for w in group], dim=0)
                mods = modalities.repeat(len(group)) if modalities is not None else None
                return predict(windows, mods).float().reshape(len(group), b, *roi, out_ch)

            for r, round_ids in enumerate(rounds):
                if fan is None:
                    outs = [run(groups[round_ids[0]]).to(acc.device)]
                else:
                    # one all-gather of the round's groups, each padded to k windows
                    mine = run(groups[round_ids[fan[2]]])
                    if len(mine) < k:
                        mine = torch.cat([mine, mine.new_zeros((k - len(mine), *mine.shape[1:]))])
                    outs = all_gather_line(mine, fan[0]).unbind(0)
                for j, g in enumerate(round_ids):
                    if r * line + j >= len(groups):
                        break   # a padded repeat
                    for i, w in enumerate(groups[g]):
                        acc[(slice(None), *w)] += outs[j][i] * imp
                if progress:
                    _tick(r + 1, len(rounds))
            return acc.div_(count)[crop]

        return fn, starts, imp, count

    @torch.inference_mode()
    def __call__(self, inputs: torch.Tensor, modalities: torch.Tensor | None = None):
        """`inputs [B, *spatial, C]` -> f32 blended logits
        `[B, *spatial, out_channels]` on the inferer's device."""
        x = torch.as_tensor(inputs, device=self.device)
        if modalities is not None:
            modalities = torch.as_tensor(modalities, device=self.device)
        fn, _, imp, count = self.program(tuple(x.shape[1:-1]))
        return fn(x, modalities, imp, count).to(self.device)


def _tick(n: int, total: int) -> None:
    sys.stderr.write(f"\r[sliding-window] {n}/{total}" + ("\n" if n == total else ""))
    sys.stderr.flush()
