"""Serving bundles as exported programs (counterpart of
`miseg_tpu/serve.py:92-361`).

A port bundle is a directory (version 3):
    meta.json    roi / channels / overlap / spacing / dtypes / the model
                 config, the platforms it serves on, whether a baked
                 window program ships, and its volume programs — what
                 the serving side needs besides the programs
    weights.pt   the state dict, saved with `torch.save` in the compute
                 dtype (bf16 under amp), but for a batch norm's running
                 statistics, which stay f32 (the JAX package's bundles
                 drop them: ROADMAP W9)
    window_fn.pt2
                 `torch.export` of the window forward
                 `(weights dict, window [B, *roi, Cin] f32, modalities
                 i32[B]) -> f32 logits`, traced through
                 `torch.func.functional_call` so that the weights are
                 arguments (`weights.pt` supplies them)
    window_fn_baked.pt2
                 only under `bake_params`: the same program with the
                 weights inside the artifact, `(window, modalities)`
    volume_<DxHxW>.npz
                 for each volume shape: the window starts, the importance
                 map and the blend count of its sliding-window program

The programs are traced on the CPU, under `eval()` and `torch.no_grad()`,
whatever host exports them, so a host without a card can export for one.
Each of the five kernels is a `miseg::` op in them (`ops/kernels`), so a
loaded program launches the hand-written kernels on the card and their
plain versions on the CPU; `load_bundle` moves a program onto the device
it serves on (`torch.export.passes.move_to_device_pass`).  Loading needs
no model code and no `Config`.

`bake_params` here means only that the `.pt2` carries its own weights;
the argument form reads `weights.pt`.  The JAX package's story (on a TPU
v5e the argument form ran at 0.83x the live model and a baked program at
1.0x, because XLA folds constant weights) does not carry over: the card
runs the same kernels on both, and `chip_smoke.py` measures both forms.

`load_bundle` loads one window program (the baked one where it ships)
and calls its graph with the inputs that do not change gathered once, so
a call passes only the window and its modalities.  On the card
`ServedModel` captures a batch of it as one CUDA graph at the first call
and replays that graph for every window batch of every request, whatever
the volume's shape.

The volume programs are not exported as `.pt2`: unrolled over 64 windows
such a graph would hold tens of thousands of nodes.  A volume program is
the window program inside the inferer's `program` (pad, gather window
groups, predict, blend, normalize, crop) for its one shape;
`ServedModel` builds it at first use and, on the card, captures it once
as a CUDA graph of its own and replays it for each matching request.

A bundle of version 1 or 2 (no programs) still loads: the model is
rebuilt from its config and `weights.pt`.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import warnings
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call

from .config import Config
from .inferers import SlidingWindowInferer
from .models import buffer_names, model_from_config
from .ops.kernels import counters
from .utils.platform import resolve_device

_BUNDLE_VERSION = 3
_META_FILE = "meta.json"
_WEIGHTS_FILE = "weights.pt"
_FN_FILE = "window_fn.pt2"
_FN_BAKED_FILE = "window_fn_baked.pt2"
_TRACED_ON = "cpu"
# platform names -> the device type that serves them: JAX's "tpu" is this
# build's accelerator, so JAX's default ("tpu", "cpu") exports alike
_PLATFORMS = {"cuda": "cuda", "tpu": "cuda", "cpu": "cpu"}

_log = logging.getLogger(__name__)


def _compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.amp else torch.float32


def normalize_platforms(platforms: Sequence[str]) -> list[str]:
    """The device types `platforms` name, in order, each once: "cuda",
    "cpu", or "tpu" (read as "cuda").  Any other name raises."""
    out = []
    for name in platforms:
        if name not in _PLATFORMS:
            raise ValueError(f"unknown export platform {name!r}: the port serves on "
                             f"{sorted(_PLATFORMS)} ('tpu' is read as 'cuda')")
        if _PLATFORMS[name] not in out:
            out.append(_PLATFORMS[name])
    return out


def _window_fn(model, compute_dtype: torch.dtype):
    """(window, modalities) -> f32 logits, with the model's weights already
    in `compute_dtype`."""

    def fn(window, modalities):
        return model(window.to(compute_dtype), modalities).float()

    return fn


class _WindowProgram(torch.nn.Module):
    """The argument form's forward: `(weights, window, modalities)`.  The
    model is held outside the module's registry, so its own tensors are
    neither lifted nor saved: `functional_call` puts `weights` in their
    place."""

    def __init__(self, model: torch.nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.compute_dtype = compute_dtype

    def forward(self, weights: dict, window, modalities):
        return functional_call(self.model, weights,
                               (window.to(self.compute_dtype), modalities)).float()


class _BakedWindowProgram(torch.nn.Module):
    """The baked form's forward: `(window, modalities)`, the weights the
    model's own."""

    def __init__(self, model: torch.nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, window, modalities):
        return self.model(window.to(self.compute_dtype), modalities).float()


def _export(module: torch.nn.Module, args: tuple, path: Path) -> None:
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    program.example_inputs = None   # the weights are arguments: keep them out of the file
    torch.export.save(program, path)


def export_bundle(cfg: Config, state_dict: dict, out_dir: str | Path,
                  platforms: Sequence[str] = ("tpu", "cpu"),
                  sw_batch_size: int | None = None,
                  volume_shapes: Sequence[Sequence[int]] = (),
                  volume_mode: str = "gaussian",
                  bake_params: bool = False) -> Path:
    """Write `cfg`'s model with weights `state_dict` as a version-3 bundle
    at `out_dir` (see the module docstring), JAX's `export_bundle`
    parameters and all.  `platforms` are the device types the bundle
    serves on (`normalize_platforms`); the window batch is fixed to
    `sw_batch_size` (default: the config's); each of `volume_shapes` gets
    a volume program with blend `volume_mode` at the config's overlap;
    `bake_params` adds `window_fn_baked.pt2` and makes the volume programs
    run it."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    platforms = normalize_platforms(platforms)
    compute = _compute_dtype(cfg)
    bs = int(sw_batch_size or cfg.sw_batch_size)
    in_ch = int(cfg.in_channels)
    buffers = buffer_names(cfg)
    weights = {k: (v.detach().to("cpu", compute)
                   if v.is_floating_point() and k not in buffers
                   else v.detach().cpu()) for k, v in state_dict.items()}
    torch.save(weights, out / _WEIGHTS_FILE)

    model = model_from_config(cfg, device=_TRACED_ON, dtype=compute)
    model.load_state_dict(weights, strict=True)
    window = torch.zeros((bs, *cfg.roi, in_ch), dtype=torch.float32)
    mods = torch.zeros((bs,), dtype=torch.int32)
    _export(_WindowProgram(model, compute), (weights, window, mods), out / _FN_FILE)
    if bake_params:
        _export(_BakedWindowProgram(model, compute), (window, mods), out / _FN_BAKED_FILE)

    volume_programs = []
    for spatial in volume_shapes:
        spatial = tuple(int(s) for s in spatial)
        inferer = SlidingWindowInferer(
            None, roi_size=tuple(cfg.roi), sw_batch_size=bs, overlap=float(cfg.infer_overlap),
            mode=volume_mode, out_channels=int(cfg.out_channels), device=_TRACED_ON)
        _, starts, imp, count = inferer.program(spatial)
        tag = "x".join(str(s) for s in spatial)
        np.savez(out / f"volume_{tag}.npz", starts=np.asarray(starts, np.int32),
                 imp=imp.numpy(), count=count.numpy())
        volume_programs.append({
            "tag": tag, "spatial": list(spatial), "batch": 1, "mode": volume_mode,
            "overlap": float(cfg.infer_overlap), "params_baked": bool(bake_params)})

    meta = {
        "bundle_version": _BUNDLE_VERSION,
        "platforms": platforms,
        "roi": list(cfg.roi),
        "in_channels": in_ch,
        "out_channels": int(cfg.out_channels),
        "sw_batch_size": bs,
        "infer_overlap": float(cfg.infer_overlap),
        "spacing": [float(s) for s in cfg.spacing],
        "compute_dtype": str(compute).removeprefix("torch."),
        "params_dtype": str(compute).removeprefix("torch."),
        "torch_version": torch.__version__,
        "model_name": cfg.model_name,
        "window_baked": bool(bake_params),
        "volume_programs": volume_programs,
        "config": cfg.to_dict(),
    }
    (out / _META_FILE).write_text(json.dumps(meta, indent=2))
    return out


def save_bundle(cfg: Config, state_dict: dict, out_dir: str | Path) -> Path:
    """`export_bundle` with its defaults."""
    return export_bundle(cfg, state_dict, out_dir)


class _Graph:
    """`fn` over inputs of fixed shapes and dtypes (`inputs`: one (shape,
    dtype) each), captured as a CUDA graph on the card.  The first call
    warms `fn` up on a side stream (which makes every plan, packed weight
    copy and arrival counter buffer the kernels take, outside the capture)
    and captures it on that stream; each call then copies its arguments
    into the graph's inputs, replays it and returns a copy of its output.
    A lock guards the static buffers: `predict` is public and servers are
    threaded.  On the CPU `fn` runs as it is.  `calls` counts the calls,
    `capture_s` the seconds of the first one's warm-up and capture."""

    def __init__(self, fn, inputs: Sequence[tuple[tuple, torch.dtype]], device: torch.device,
                 weights: list):
        self.fn, self.inputs, self.device = fn, list(inputs), device
        self.weights = weights   # the tensors whose packed copies the graph reads
        self.graph = None
        self.capture_s = None
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, *args):
        if self.device.type != "cuda":
            self.calls += 1
            return self.fn(*args)
        with self._lock:
            self.calls += 1
            if self.graph is None:
                self._capture()
            for buf, arg in zip(self._static, args):
                buf.copy_(arg)
            self.graph.replay()
            return self._out.clone()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        self._static = [torch.zeros(shape, dtype=dtype, device=dev)
                        for shape, dtype in self.inputs]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.fn(*self._static)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            self._out = self.fn(*self._static)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # what the graph reads but does not own: the stream's arrival
        # counters and the weights' packed K4 copies stay alive with it
        self._keep = [counters.arrival_counters(dev, stream.cuda_stream, 1)]
        self._keep += [w._miseg_k4_weights[1] for w in self.weights
                       if hasattr(w, "_miseg_k4_weights")]
        self._stream, self.graph = stream, graph
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0


class ServedModel:
    """A loaded bundle: window-level `__call__` and volume-level `predict`.

    `form` is the window program served: "baked" (the `.pt2` carries its
    weights) or "arguments" (the weights from `weights.pt`; a version-1 or
    2 bundle's rebuilt model, held in `model`, counts as this form).
    `window_fn(window, modalities) -> f32 logits` runs it as it is, for
    any number of windows; `__call__` serves it, on the card as one CUDA
    graph of a window batch captured at the first call and replayed for
    every window batch of every request.  `state_dict()` gives the
    bundle's weights."""

    def __init__(self, meta: dict, device, form: str, window_fn, weights: list, *,
                 state: dict | None = None, model=None, bundle_dir: Path | None = None):
        self.meta = meta
        self.device = torch.device(device)
        self.compute_dtype = getattr(torch, meta["compute_dtype"])
        self.form = form
        self.window_fn = window_fn
        self.model = model
        self._state = state
        self._bundle_dir = Path(bundle_dir) if bundle_dir else None
        self._weights = weights
        batch, roi = int(meta["sw_batch_size"]), tuple(meta["roi"])
        self.window_graph = _Graph(
            window_fn, [((batch, *roi, int(meta["in_channels"])), torch.float32),
                        ((batch,), torch.int32)], self.device, weights)
        self._window = _fixed_batch(self.window_graph, batch)
        self._inferers: dict = {}
        self._volume_fns: dict = {}   # tag -> _Graph, or None if unusable
        self._fallbacks_logged: set = set()
        self._lock = threading.Lock()

    def state_dict(self) -> dict:
        """The bundle's weights: on the device in the argument form, read
        from `weights.pt` onto the CPU in the baked one (whose program
        holds its own copy on the device)."""
        if self._state is None:
            return torch.load(self._bundle_dir / _WEIGHTS_FILE, map_location="cpu",
                              weights_only=True)
        return self._state

    @torch.inference_mode()
    def __call__(self, window, modalities):
        return self._window(torch.as_tensor(window, dtype=torch.float32, device=self.device),
                            torch.as_tensor(modalities, dtype=torch.int32,
                                            device=self.device))

    def _inferer(self, window_fn, overlap: float, mode: str) -> SlidingWindowInferer:
        return SlidingWindowInferer(
            window_fn, roi_size=tuple(self.meta["roi"]),
            sw_batch_size=int(self.meta["sw_batch_size"]), overlap=overlap, mode=mode,
            out_channels=int(self.meta["out_channels"]), device=self.device)

    def volume_program(self, spatial, batch: int = 1, overlap: float | None = None,
                       mode: str = "gaussian"):
        """The bundle's volume program for a request of this (spatial
        shape, batch, overlap, mode), loaded at its first use, or None
        when no volume program is listed for it or its `.npz` does not
        load."""
        ov = float(self.meta["infer_overlap"] if overlap is None else overlap)
        for entry in self.meta.get("volume_programs", ()):
            if (tuple(entry["spatial"]) == tuple(spatial) and entry["batch"] == batch
                    and entry["mode"] == mode and abs(entry["overlap"] - ov) < 1e-9):
                tag = entry["tag"]
                with self._lock:
                    if tag not in self._volume_fns:
                        self._volume_fns[tag] = self._load_volume(entry)
                return self._volume_fns[tag]
        return None

    def loaded_volume_programs(self) -> list[str]:
        """The tags of the volume programs loaded so far and usable."""
        return sorted(tag for tag, prog in self._volume_fns.items() if prog is not None)

    def _load_volume(self, entry: dict):
        tag = entry["tag"]
        try:
            if self._bundle_dir is None:
                raise FileNotFoundError("the bundle has no directory")
            aux = np.load(self._bundle_dir / f"volume_{tag}.npz")
        except (FileNotFoundError, OSError) as e:
            # a partly copied bundle: the window program still serves
            warnings.warn(f"volume program {tag} unusable ({e}); falling back to the "
                          "window-level inferer")
            return None
        fn, starts, _, _ = self._inferer(self.window_fn, float(entry["overlap"]),
                                         entry["mode"]).program(entry["spatial"])
        if not np.array_equal(np.asarray(starts), aux["starts"]):
            raise ValueError(f"volume program {tag}: the bundle's window starts differ "
                             "from this runtime's grid")
        imp, count = (torch.from_numpy(aux[k]).to(self.device) for k in ("imp", "count"))
        inputs = [((1, *entry["spatial"], int(self.meta["in_channels"])), torch.float32),
                  ((1,), torch.int32)]
        return _Graph(lambda volume, mods: fn(volume, mods, imp, count), inputs,
                      self.device, self._weights)

    @torch.inference_mode()
    def predict(self, volume, modalities, *, overlap: float | None = None,
                mode: str = "gaussian") -> torch.Tensor:
        """Sliding-window inference over `volume [B, *spatial, Cin]`;
        returns f32 logits `[B, *spatial, out_channels]` on the device.  A
        volume whose (spatial shape, batch 1, overlap, mode) matches one of
        the bundle's volume programs runs through it (on the card, one
        replay of its CUDA graph); anything else runs the served window
        (on the card, a replay of the window graph for each window batch)
        in the generic inferer, with a warning once per shape."""
        ov = float(self.meta["infer_overlap"] if overlap is None else overlap)
        vol = torch.as_tensor(volume, dtype=torch.float32, device=self.device)
        mods = torch.as_tensor(modalities, dtype=torch.int32, device=self.device)
        prog = self.volume_program(tuple(vol.shape[1:-1]), vol.shape[0], ov, mode)
        if prog is not None:
            return prog(vol, mods)
        key = (tuple(vol.shape), ov, mode)
        if key not in self._fallbacks_logged:
            self._fallbacks_logged.add(key)
            _log.warning(
                "serve: volume %s overlap=%.2f mode=%s matches no volume program of the "
                "bundle: served window by window through the generic inferer.  Re-export "
                "with --export_volume_shapes %s to serve it as one program.",
                tuple(vol.shape), ov, mode, "x".join(str(s) for s in vol.shape[1:-1]))
        if (ov, mode) not in self._inferers:
            self._inferers[(ov, mode)] = self._inferer(self._window, ov, mode)
        return self._inferers[(ov, mode)](vol, mods)


def _fixed_batch(program, batch: int):
    """`program`, exported for windows of `batch`, over any number of
    windows: in chunks of `batch`, a short last chunk padded with copies
    of its last window whose logits are dropped (JAX's grouped starts
    repeat the last window the same way)."""

    def fn(window, modalities):
        n = window.shape[0]
        if n == batch:
            return program(window, modalities)
        outs = []
        for i in range(0, n, batch):
            w, m = window[i:i + batch], modalities[i:i + batch]
            short = batch - w.shape[0]
            if short:
                w = torch.cat([w, w[-1:].expand(short, *w.shape[1:])])
                m = torch.cat([m, m[-1:].expand(short)])
            outs.append(program(w, m))
        return torch.cat(outs)[:n]

    return fn


def _flat_program(path: Path, device: torch.device, weights: dict | None = None):
    """The exported window program at `path`, on `device`, as
    `(window, modalities) -> logits`: its unlifted graph called with flat
    inputs, those that do not change from call to call (in the argument
    form, `weights`) flattened once here; the per-call pytree flatten and
    input checks of `ExportedProgram.module()` are taken out.  Returns
    (the function, the tensors it reads)."""
    from torch.utils import _pytree as pytree

    program = torch.export.load(path)
    if device.type != _TRACED_ON:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    module = program.module()
    window, mods = object(), object()
    user, spec = pytree.tree_flatten((((weights, window, mods) if weights is not None
                                       else (window, mods)), {}))
    placeholders = [n for n in module.graph.nodes if n.op == "placeholder"]
    if (spec != module._in_spec or user[-2] is not window or user[-1] is not mods
            or len(placeholders) != len(user)):
        raise ValueError(f"{path.name}: its inputs are not this runtime's window program's")
    fixed = user[:-2]
    module.graph._codegen = torch.fx.graph.CodeGen()   # flat inputs in, flat outputs out
    module.recompile()
    module._forward_pre_hooks.clear()
    module._forward_hooks.clear()

    def fn(w, m):
        return module(*fixed, w, m)[0]

    return fn, [*fixed, *module.parameters(), *module.buffers()]


def load_bundle(bundle_dir: str | Path, device=None, *, form: str | None = None) -> ServedModel:
    """Load a serving bundle onto `device` (the CUDA card unless given).
    A version-3 bundle loads one exported window program, with no model
    code or `Config`: `form` "baked" or "arguments", by default the baked
    one where the bundle ships it; it raises for a device type the bundle
    was not exported for.  An older bundle rebuilds the model from its
    config."""
    device = resolve_device(device)
    d = Path(bundle_dir)
    meta = json.loads((d / _META_FILE).read_text())
    version = meta.get("bundle_version", 0)
    if version > _BUNDLE_VERSION:
        raise ValueError(f"bundle version {version} is newer "
                         f"than this runtime supports ({_BUNDLE_VERSION})")
    shipped = ["arguments", "baked"] if meta.get("window_baked") else ["arguments"]
    form = form or shipped[-1]
    if form not in shipped:
        raise ValueError(f"the bundle ships the window forms {shipped}, not {form!r}")
    batch = int(meta["sw_batch_size"])
    # the weights must not be inference tensors: K4 caches its packed
    # copy of a weight by the weight's version counter
    with torch.inference_mode(False):
        if version < 3:
            state = torch.load(d / _WEIGHTS_FILE, map_location=device, weights_only=True)
            cfg = Config(**meta["config"])
            model = model_from_config(cfg, device=device,
                                      dtype=getattr(torch, meta["params_dtype"]))
            model.load_state_dict(state, strict=True)
            window = _window_fn(model.eval(), getattr(torch, meta["compute_dtype"]))
            return ServedModel(meta, device, form, window, list(model.parameters()),
                               state=model.state_dict(), model=model, bundle_dir=d)
        if device.type not in meta["platforms"]:
            raise ValueError(f"the bundle was exported for {meta['platforms']}, not for "
                             f"{device.type}")
        if form == "baked":
            fn, weights = _flat_program(d / _FN_BAKED_FILE, device)
            state = None
        else:
            state = torch.load(d / _WEIGHTS_FILE, map_location=device, weights_only=True)
            fn, weights = _flat_program(d / _FN_FILE, device, state)
    return ServedModel(meta, device, form, _fixed_batch(fn, batch), weights, state=state,
                       bundle_dir=d)
