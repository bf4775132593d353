"""One rank of the spatial-partitioning CPU tests (`tests/test_torch_spatial.py`).

    python tests/_torch_spatial_worker.py SUITE RANK WORLD RDZV_FILE OUT_DIR STARTS

Joins a gloo process group through a `file://` rendezvous and runs the
cases of `SUITES[SUITE]` on its share of each global batch (its "data"
coordinate's batch; the Trainer cuts its slab of dim 1), from the state dicts of
`STARTS` (`torch.save`d `{model: state dict}`):

  * "sp2" (world 2, the line `[2]`): `functions`, the pieces of
    `parallel/spatial.py` and the layers' partitioned kernels against
    autograd on the whole volume, each as its largest gap; `losses`, each
    loss of `losses.py` over the slabs against the whole patch; one SGD
    step of JAX's tiny C-UNet and of its tiny swin (without and with
    dropout); beside FSDP on the spatial line, the C-UNet's step, an fs-24
    swin's, and a C-UNet's whose patch (D 18) the level rule keeps whole;
    the `MODEL_CASES` of the line `[2]` (a tiny C-UNETR without and with
    ViT dropout, a tiny UNetVanilla and its batch-norm recipe, the four
    families in 2-D); the swin's forward and its 2-D twin's in eval mode,
    the logits gathered whole; the refusals, and a step of each
    configuration they once held (`refusals`).
  * "sp4" (world 4): the C-UNet step on the line `[4]` and on the
    ("data", "sp") mesh `[2, 2]`, and beside FSDP on `[4]` (the spatial
    line) and on `[2, 2]` (FSDP on "data", and on "sp"); the tiny C-UNETR
    on `[4]` and `[2, 2]`, the tiny UNetVanilla on `[4]`.
  * Both: the sliding-window inferer fanned out over the world (`fanout`:
    its logits and predict calls, and with `stitch_on_host`), and
    `Trainer.evaluate` on `[2]` ("sp2") or `[2, 2]` ("sp4") of the
    volumes of `eval_volumes`.

Each step records the loss, the whole parameters after the update, the
gradients it applied (both gathered whole where FSDP shards them), a
digest of the gathered masters, the bytes of masters and momentum this
rank holds, and beside FSDP a checkpoint round trip (`round_trip`).
Saves what it saw to `OUT_DIR/<SUITE>_rank<RANK>.pt`.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from miseg_tpu_torch import losses as L  # noqa: E402
from miseg_tpu_torch import parallel  # noqa: E402
from miseg_tpu_torch.config import Config  # noqa: E402
from miseg_tpu_torch.inferers import SlidingWindowInferer  # noqa: E402
from miseg_tpu_torch.models import model_from_config  # noqa: E402
from miseg_tpu_torch.ops import norms as N  # noqa: E402
from miseg_tpu_torch.ops.kernels import fused_conv, fused_norm  # noqa: E402
from miseg_tpu_torch.parallel import fsdp, spatial  # noqa: E402
from miseg_tpu_torch.train import engine  # noqa: E402
from miseg_tpu_torch.utils.logging import MetricLogger  # noqa: E402

# JAX's tiny C-UNet (tests/test_spatial.py:45-52) under SGD, and its tiny
# swin (:148-176) as a training configuration
MODELS = {
    "unet": dict(model_name="unet", roi_x=16, roi_y=16, roi_z=16, out_channels=2,
                 feature_size=[8], num_layers=2, strides=[2], num_res_units=1,
                 encoder_norm_name="instance_cond", decoder_norm_name="instance",
                 criterion="dice_ce", batch_size=8, scheduler="none", no_amp=True,
                 precision="fp32", optim_name="sgd"),
    "swin": dict(model_name="swin_unetr", roi_x=32, roi_y=32, roi_z=32, out_channels=4,
                 feature_size=[12], num_heads=2, depth_swin_block=[1],
                 vit_norm_name="instance_cond", encoder_norm_name="instance_cond",
                 decoder_norm_name="instance", criterion="dice_focal", no_amp=True,
                 optim_name="sgd", lr=1e-2),
}
# the C-UNet with batch norms: its statistics over the data x spatial ranks
MODELS["unet_batch"] = dict(MODELS["unet"], encoder_norm_name="batch", decoder_norm_name="batch")
# the tiny swin at fs 24, and a C-UNet whose patch's D (18: 9 planes a rank
# of [2]) the level rule keeps whole
MODELS["swin24"] = dict(MODELS["swin"], feature_size=[24])
MODELS["unet_whole"] = dict(MODELS["unet"], roi_x=18)
# a tiny C-UNETR at 64^3: its token level (4 planes) is sharded on [2] (2
# planes a rank) and whole on [4]; with ViT dropout (JAX draws other masks)
_NORMS = dict(vit_norm_name="instance_cond", encoder_norm_name="instance_cond",
              decoder_norm_name="instance")
MODELS["unetr"] = dict(model_name="unetr", roi_x=64, roi_y=64, roi_z=64, out_channels=3,
                       feature_size=[4], hidden_size=16, mlp_dim=32, num_heads=2, **_NORMS,
                       criterion="dice_ce", no_amp=True, optim_name="sgd", lr=1e-2)
MODELS["unetr_dropout"] = dict(MODELS["unetr"], dropout_rate=0.3)
# a tiny UNetVanilla of the README recipe's strides (1 2 2 2 1: pre_conv
# and the bottom unit keep their level) at 16^3: its 2-plane level is whole
# on [2] and its 4-plane one on [4], each upsampled into a sharded level;
# and with batch norms
MODELS["vanilla"] = dict(model_name="unet_vanilla", roi_x=16, roi_y=16, roi_z=16,
                         out_channels=3, feature_size=[4, 8, 8, 16, 16],
                         strides=[1, 2, 2, 2, 1], num_res_units=2, **_NORMS,
                         criterion="dice_ce", no_amp=True, optim_name="sgd", lr=1e-2)
MODELS["vanilla_batch"] = dict(MODELS["vanilla"], encoder_norm_name="batch",
                               decoder_norm_name="batch")
# the four families in 2-D: the slab is H of [B, H, W, C]
_2D = dict(spatial_dims=2, roi_x=64, roi_y=64)
MODELS["swin_2d"] = dict(MODELS["swin"], **_2D)
MODELS["unetr_2d"] = dict(MODELS["unetr"], **_2D)
MODELS["unet_2d"] = dict(MODELS["unet"], spatial_dims=2, roi_x=32, roi_y=32)
MODELS["vanilla_2d"] = dict(MODELS["vanilla"], spatial_dims=2, roi_x=32, roi_y=32)
DROPOUT = dict(dropout_rate=0.2, attn_drop_rate=0.1, dropout_path_rate=0.1)
# FSDP on the leaves of 128 elements or more (the tiny models have few above
# JAX's default 8192), on the spatial line or on "data"
FSDP_SP = dict(fsdp=True, fsdp_min_size=128, fsdp_axis="sp")
FSDP_DATA = dict(fsdp=True, fsdp_min_size=128, fsdp_axis="data")
# case -> (model, mesh shape, mesh axes, extra fields)
CASES = {
    "unet_sp2": ("unet", [2], ["sp"], {}),
    "swin_sp2": ("swin", [2], ["sp"], {}),
    "swin_dropout_sp2": ("swin", [2], ["sp"], DROPOUT),
    "unet_batch_sp2": ("unet_batch", [2], ["sp"], {}),
    "unet_fsdp_sp2": ("unet", [2], ["sp"], FSDP_SP),
    "swin24_fsdp_sp2": ("swin24", [2], ["sp"], FSDP_SP),
    "unet_whole_fsdp_sp2": ("unet_whole", [2], ["sp"], FSDP_SP),
    "unet_sp4": ("unet", [4], ["sp"], {}),
    "unet_dp_sp": ("unet", [2, 2], ["data", "sp"], {}),
    "unet_fsdp_sp4": ("unet", [4], ["sp"], FSDP_SP),
    "unet_dp_sp_fsdp_data": ("unet", [2, 2], ["data", "sp"], FSDP_DATA),
    "unet_dp_sp_fsdp_sp": ("unet", [2, 2], ["data", "sp"], FSDP_SP),
    "unetr_sp2": ("unetr", [2], ["sp"], {}),
    "unetr_sp4": ("unetr", [4], ["sp"], {}),
    "unetr_dp_sp": ("unetr", [2, 2], ["data", "sp"], {}),
    "unetr_dropout_sp2": ("unetr_dropout", [2], ["sp"], {}),
    "vanilla_sp2": ("vanilla", [2], ["sp"], {}),
    "vanilla_sp4": ("vanilla", [4], ["sp"], {}),
    "vanilla_batch_sp2": ("vanilla_batch", [2], ["sp"], {}),
    "swin_2d_sp2": ("swin_2d", [2], ["sp"], {}),
    "unetr_2d_sp2": ("unetr_2d", [2], ["sp"], {}),
    "unet_2d_sp2": ("unet_2d", [2], ["sp"], {}),
    "vanilla_2d_sp2": ("vanilla_2d", [2], ["sp"], {}),
}
# the steps of every model family beyond the C-UNet and the 3-D swin
MODEL_CASES = ["unetr_sp2", "unetr_sp4", "unetr_dp_sp", "unetr_dropout_sp2", "vanilla_sp2",
               "vanilla_sp4", "vanilla_batch_sp2", "swin_2d_sp2", "unetr_2d_sp2",
               "unet_2d_sp2", "vanilla_2d_sp2"]
SUITES = {"sp2": ["unet_sp2", "unet_batch_sp2", "swin_sp2", "swin_dropout_sp2",
                  "unet_fsdp_sp2", "swin24_fsdp_sp2", "unet_whole_fsdp_sp2",
                  *(c for c in MODEL_CASES if CASES[c][1] == [2])],
          "sp4": ["unet_sp4", "unet_dp_sp", "unet_fsdp_sp4", "unet_dp_sp_fsdp_data",
                  "unet_dp_sp_fsdp_sp", *(c for c in MODEL_CASES if CASES[c][1] != [2])]}
FSDP_CASES = [c for c, (_, _, _, extra) in CASES.items() if extra.get("fsdp")]
GLOBAL_BATCH = 2
# the window fan-out: name -> (volume, sw_batch_size, batch); 6 groups; 2
# groups of 4 and 2 windows; 3 groups of 3, 3 and 2 windows (a padded volume)
FANOUT = {"k1": ((24, 16, 32), 1, 1), "k4_short": ((24, 16, 32), 4, 1),
          "k3_padded": ((20, 16, 40), 3, 2)}
FANOUT_ROI = (16, 16, 16)
# the meshes `Trainer.evaluate` runs on, by suite
EVAL_MESH = {"sp2": ([2], ["sp"]), "sp4": ([2, 2], ["data", "sp"])}


def case_config(name: str, *, one_process: bool = False) -> dict:
    """A case's Config fields; `one_process`: without its mesh and FSDP
    (the one process it is held to)."""
    model, shape, axes, extra = CASES[name]
    cfg = dict(MODELS[model], **extra)
    if one_process:
        for k in FSDP_SP:
            cfg.pop(k, None)
    else:
        cfg.update(spatial_shard=True, mesh_shape=shape, mesh_axes=axes)
    return cfg


def global_batch(cfg: dict, seed: int = 1) -> dict:
    """JAX's test batch: `GLOBAL_BATCH` volumes (or 2-D slices) and labels
    from a seed, modalities 0 and 1."""
    rng = np.random.default_rng(seed)
    roi = Config(**cfg).roi
    return {"image": rng.normal(size=(GLOBAL_BATCH, *roi, 1)).astype(np.float32),
            "label": (rng.uniform(size=(GLOBAL_BATCH, *roi)) > 0.7).astype(np.int32)
            if cfg["out_channels"] == 2 else
            rng.integers(0, cfg["out_channels"], (GLOBAL_BATCH, *roi)).astype(np.int32),
            "modality": np.array([0, 1], np.int32)}


def batch_for(batch: dict) -> dict:
    """This rank's share of a global batch: its "data" coordinate's."""
    shard, shards = parallel.host_shard_info()
    n = GLOBAL_BATCH // shards
    return {k: v[shard * n:(shard + 1) * n] for k, v in batch.items()}


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def step(name: str, start: dict) -> dict:
    """One step of a case from `start`: loss, whole parameters, the applied
    gradients (both gathered where FSDP shards them), the gathered
    masters' digest, the rank's bytes of masters and momentum and its
    placements; beside FSDP the checkpoint round trip."""
    trainer = engine.Trainer(Config(**case_config(name)), device="cpu")
    state = trainer.init_state(start)
    state, loss = trainer.train_step(state, batch_for(global_batch(case_config(name))))
    params = {n: t.detach().clone() for n, t in trainer.state_dict(state).items()
              if n in state.params}
    grads = fsdp.gather_full({n: p.grad for n, p in state.params.items()}, trainer.placements)
    out = {"loss": float(loss), "sp_top": trainer._sp_top, "params": params,
           "grads": {n: g.detach().clone() for n, g in grads.items()},
           "buffers": {n: b.detach().clone() for n, b in state.buffers.items()},
           "digest": digest(params), "state_bytes": trainer.state_bytes(state),
           "placed": {n: (pl.kind, pl.axis, pl.size) for n, pl in trainer.placements.items()}}
    if trainer.placements:
        out["round_trip"] = round_trip(trainer, state, start)
    return out


def momenta(trainer, state) -> dict:
    """SGD's momentum buffers by parameter name, whole."""
    sd = trainer.opt_state(state)["optimizer"]["state"]
    names = trainer._opt_names(state)
    return {names[int(i)]: st["momentum_buffer"].clone() for i, st in sd.items()}


def round_trip(trainer, state, start: dict) -> dict:
    """The checkpoint of the stepped state (parameters, buffers and the
    optimizer's state, whole, as `fit` writes them) restored into a fresh
    state of the same Trainer: whether gathering it again gives the same
    bits, and the checkpoint's momentum."""
    ck = {"params": {n: t.clone() for n, t in trainer.state_dict(state).items()},
          "opt_state": trainer.opt_state(state)}
    moments = momenta(trainer, state)
    again = trainer.restore(trainer.init_state(start), ck)
    back = trainer.state_dict(again)
    back_moments = momenta(trainer, again)
    return {"params_equal": back.keys() == ck["params"].keys() and all(
                torch.equal(t, ck["params"][n]) for n, t in back.items()),
            "moments_equal": back_moments.keys() == moments.keys() and all(
                torch.equal(t, moments[n]) for n, t in back_moments.items()),
            "moments": moments}


def fanout_model(windows: torch.Tensor, modalities: torch.Tensor) -> torch.Tensor:
    """A model whose windows differ by place and modality: `[roll(w, 1) x 2
    + m, w + 1]` (tests/test_inferer.py's sum model, with a roll along D)."""
    m = modalities.to(windows.dtype)[:, None, None, None, None]
    return torch.cat([torch.roll(windows, 1, dims=1) * 2.0 + m, windows + 1.0], -1)


def fanout_input(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(volume `[B, *spatial, 1]`, modalities) of a `FANOUT` case, from a seed."""
    spatial_, _, b = FANOUT[name]
    rng = np.random.default_rng(11)
    return (rng.random((b, *spatial_, 1)).astype(np.float32),
            (np.arange(b) % 2).astype(np.int32))


def fanout() -> dict:
    """Each `FANOUT` case through the gaussian inferer on the mesh `[world]`
    ("data"): the logits, the predict calls and `windows_predicted`, fanned
    out and under `stitch_on_host` (no fan-out)."""
    mesh = parallel.make_mesh([dist.get_world_size()], ["data"])
    out = {}
    for name, (spatial_, k, _) in FANOUT.items():
        x, mods = (torch.from_numpy(a) for a in fanout_input(name))
        for host in (False, True):
            calls = []

            def predict(w, m):
                calls.append(w.shape[0])
                return fanout_model(w, m)

            inferer = SlidingWindowInferer(predict, FANOUT_ROI, k, 0.5, "gaussian",
                                           out_channels=2, stitch_on_host=host, device="cpu",
                                           mesh=mesh)
            out[name, host] = {"logits": inferer(x, mods), "calls": len(calls),
                               "windows": inferer.windows_predicted(spatial_)}
    return out


def eval_volumes(seed: int = 12) -> list[dict]:
    """The validation volumes of `evaluate`: a 32 x 16 x 16 one (3 windows of
    16^3) and a 24 x 16 x 32 one (6), with labels, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for m, shape in enumerate(((32, 16, 16), (24, 16, 32))):
        out.append({"image": rng.normal(size=(1, *shape, 1)).astype(np.float32),
                    "label": (rng.uniform(size=(1, *shape)) > 0.6).astype(np.int32),
                    "modality": np.array([m], np.int32)})
    return out


def evaluate(suite: str, start: dict) -> dict:
    """`Trainer.evaluate` of the C-UNet (spatial partitioning on the suite's
    `EVAL_MESH`) on `eval_volumes`: the metrics and the windows this rank
    predicted."""
    shape, axes = EVAL_MESH[suite]
    cfg = Config(**MODELS["unet"], spatial_shard=True, mesh_shape=shape, mesh_axes=axes)
    trainer = engine.Trainer(cfg, device="cpu", logger=MetricLogger(None, quiet=True))
    metrics = trainer.evaluate(eval_volumes(), trainer.init_state(start))
    return {"metrics": metrics, "windows": trainer.history["eval_windows"]}


def forward_input(model: str, seed: int = 4) -> np.ndarray:
    """The swin forward's input: JAX's (`test_spatial.py:163-165`) for the
    tiny swin, a 2-D slice of the same draw for its 2-D twin."""
    roi = Config(**MODELS[model]).roi
    return np.random.default_rng(seed).normal(size=(1, *roi, 1)).astype(np.float32)


def swin_forward(model: str, start: dict) -> torch.Tensor:
    """A tiny swin's eval-mode forward on the line (`forward_input`), this
    rank's slab of dim 1 in, the logits gathered whole."""
    cfg = Config(**MODELS[model])
    net = model_from_config(cfg, device="cpu")
    net.load_state_dict(start)
    net.eval()
    x = torch.from_numpy(forward_input(model))
    d, h = x.shape[1:3]
    mesh = parallel.make_mesh([dist.get_world_size()], ["sp"])
    n, r = mesh.size("sp"), mesh.index("sp")
    with torch.no_grad(), spatial.partition(mesh.group("sp"), n, r, d, h, ndim=x.ndim):
        y = net(x[:, r * d // n:(r + 1) * d // n], torch.tensor([1], dtype=torch.int32))
        return spatial.gather_d(y, spatial.active())


def _gap(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max())


def functions() -> dict:
    """Each piece of `parallel/spatial.py` and each partitioned kernel path
    against autograd on the whole volume, at the line [world]: forward and
    gradient gaps by name (the same seeded inputs on every rank, each
    rank's own random weights on its output drawn from one list)."""
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = parallel.make_mesh([n], ["sp"])
    g = torch.Generator().manual_seed(0)
    d, h = 8, 6
    line = spatial.Line(mesh.group("sp"), n, r, d, h)
    dl = d // n
    mine = slice(r * dl, (r + 1) * dl)
    out = {}

    def whole_and_slab(shape):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        return x.clone().requires_grad_(), x[:, mine].clone().requires_grad_()

    # halo_d: every (lo, hi), a weight on each rank's halo'd slab
    for lo, hi in ((1, 1), (1, 0), (0, 1), (2, 1), (1, -1)):
        xw, xs = whole_and_slab((2, d, h, 3, 2))
        size = dl + lo + hi
        ws = [torch.randn((2, size, h, 3, 2), generator=g, dtype=torch.float64)
              for _ in range(n)]
        got = spatial.halo_d(xs, lo, hi, line)
        (ws[r] * got).sum().backward()
        # the volume with lo zero planes before it and max(hi, 0) after it:
        # rank k's halo'd slab starts at its plane k * dl
        pad = torch.nn.functional.pad(xw, (0, 0, 0, 0, 0, 0, lo, max(hi, 0)))
        sum((ws[k] * pad[:, k * dl:k * dl + size]).sum() for k in range(n)).backward()
        want = pad[:, r * dl:r * dl + size]
        out[f"halo_d {lo} {hi}"] = max(_gap(got, want), _gap(xs.grad, xw.grad[:, mine]))
    # gather_d and slice_d
    xw, xs = whole_and_slab((2, d, h, 3, 2))
    ws = [torch.randn((2, d, h, 3, 2), generator=g, dtype=torch.float64) for _ in range(n)]
    got = spatial.gather_d(xs, line)
    (ws[r] * got).sum().backward()
    sum((w * xw).sum() for w in ws).backward()
    out["gather_d"] = max(_gap(got, xw), _gap(xs.grad, xw.grad[:, mine]))
    xw = torch.randn((2, d, h, 3, 2), generator=g, dtype=torch.float64).requires_grad_()
    ws = [torch.randn((2, dl, h, 3, 2), generator=g, dtype=torch.float64) for _ in range(n)]
    got = spatial.slice_d(xw, line)
    (ws[r] * got).sum().backward()
    want = torch.zeros_like(xw)
    want[:, mine] = ws[r]
    out["slice_d"] = max(_gap(got, xw[:, mine]), _gap(xw.grad, want))
    # gather_rows: uneven shares (3 rows over the line)
    counts = spatial.window_rows(3, line)[2]
    xw = torch.randn((2, 3, 4), generator=g, dtype=torch.float64).requires_grad_()
    first = sum(counts[:r])
    xs = xw[:, first:first + counts[r]].detach().clone().requires_grad_()
    ws = [torch.randn((2, 3, 4), generator=g, dtype=torch.float64) for _ in range(n)]
    got = spatial.gather_rows(xs, counts, line)
    (ws[r] * got).sum().backward()
    sum((w * xw).sum() for w in ws).backward()
    out["gather_rows"] = max(_gap(got, xw), _gap(xs.grad, xw.grad[:, first:first + counts[r]]))
    # sum_over_line: every rank's loss is the whole volume's
    xw, xs = whole_and_slab((2, d, h, 3, 2))
    u = torch.randn((2, d, h, 3, 2), generator=g, dtype=torch.float64)
    got = spatial.sum_over_line((xs * u[:, mine]).sum((1, 2, 3)), line)
    (got.square() * torch.arange(1, 3, dtype=torch.float64)[:, None]).sum().backward()
    want = (xw * u).sum((1, 2, 3))
    (want.square() * torch.arange(1, 3, dtype=torch.float64)[:, None]).sum().backward()
    out["sum_over_line"] = max(_gap(got, want), _gap(xs.grad, xw.grad[:, mine]))
    # merge_moments: local two-pass moments merged, against the whole's
    xw, xs = whole_and_slab((2, d, h, 3, 4))
    a = [torch.randn((2, 4), generator=g, dtype=torch.float64) for _ in range(n)]
    b = [torch.randn((2, 4), generator=g, dtype=torch.float64) for _ in range(n)]
    x3 = xs.reshape(2, -1, 4)
    mean = x3.mean(1)
    total, gm, gm2 = spatial.merge_moments(x3.shape[1], mean,
                                           (x3 - mean[:, None]).square().sum(1), line)
    (a[r] * gm + b[r] * gm2).sum().backward()
    w3 = xw.reshape(2, -1, 4)
    wm = w3.mean(1)
    wm2 = (w3 - wm[:, None]).square().sum(1)
    sum((ak * wm + bk * wm2).sum() for ak, bk in zip(a, b)).backward()
    out["merge_moments"] = max(_gap(gm, wm), _gap(gm2, wm2) / float(wm2.abs().max()),
                               _gap(xs.grad, xw.grad[:, mine]), abs(total - w3.shape[1]))
    out.update(kernels(line, g))
    return out


def kernels(line, g) -> dict:
    """K4's D-halo mode (through `spatial.conv3_halo`, without and with the
    prologue) and K1's moments mode with the line's merge (with W1's
    small-variance channel), slab by slab against the whole volume's
    plain path, forward and gradients (f32)."""
    n, r = line.size, line.index
    d, h = line.depth, line.height
    dl = d // n
    mine = slice(r * dl, (r + 1) * dl)
    out = {}
    for prologue in (False, True):
        x = torch.randn((1, d, h, h, 4), generator=g)
        w = (torch.randn((5, 4, 3, 3, 3), generator=g) / 10).requires_grad_()
        sc = (1 + 0.3 * torch.randn((1, 4), generator=g)).requires_grad_()
        sh = (0.3 * torch.randn((1, 4), generator=g)).requires_grad_()
        gamma = (1 + 0.2 * torch.randn((2, 5), generator=g)).requires_grad_()
        beta = (0.2 * torch.randn((2, 5), generator=g)).requires_grad_()
        styles = torch.tensor([1])
        dy = torch.randn((1, d, h, h, 5), generator=g)
        dcol = torch.randn((2, 1, 5), generator=g)
        kw = dict(scale=sc, shift=sh, slope=0.01) if prologue else {}
        leaves = [w, gamma, beta, *((sc, sh) if prologue else ())]
        xw = x.clone().requires_grad_()
        yw, cw, hw = fused_conv.conv3_norm_columns_plain(xw, w, **kw, gamma=gamma, beta=beta,
                                                         styles=styles)
        # the whole loss: every rank's slab of y and its share of the columns'
        ((dy * yw).sum() + (dcol[0] * cw + dcol[1] * hw).sum()).backward()
        want = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.grad = None
        xs = x[:, mine].clone().requires_grad_()
        ys, total, mean, m2 = spatial.conv3_halo(xs, w, *((sc, sh) if prologue else ()),
                                                 slope=0.01 if prologue else None, line=line)
        cs, hs = fused_norm.columns_from_moments(total, mean, m2, gamma, beta, styles)
        ((dy[:, mine] * ys).sum() + (dcol[0] * cs + dcol[1] * hs).sum() / n).backward()
        # the replicated leaves' gradients are shares: summed over the line
        got = [t.grad.clone() for t in leaves]
        for t in got:
            dist.all_reduce(t, group=line.group)
        key = f"K4 halo prologue={prologue}"
        out[key] = max(_gap(ys, yw[:, mine]), _gap(cs, cw), _gap(hs, hw),
                       _gap(xs.grad, xw.grad[:, mine]), *(_gap(a, b) for a, b in zip(got, want)))
    # K1's moments mode + merge, against the whole volume's columns taken
    # two-pass in f64 (W1's channel: mean 0.3, variance 1e-4)
    x = torch.randn((1, d, h, h, 4), generator=g)
    x[..., 0] = 0.3 + 0.01 * torch.randn((1, d, h, h), generator=g)
    gamma = 1 + 0.2 * torch.randn((2, 4), generator=g)
    beta = 0.2 * torch.randn((2, 4), generator=g)
    styles = torch.tensor([0])
    want = fused_norm.channel_scale_shift_plain(x.double().reshape(1, -1, 4), gamma.double(),
                                                beta.double(), styles)
    with spatial.partition(line.group, n, r, d, h):
        got = spatial.instance_columns(x[:, mine], gamma, beta, styles)
    out["K1 moments + merge"] = max(_gap(a.double(), b) / (1 + float(b.abs().max()))
                                    for a, b in zip(got, want))
    # group norm: each (sample, group)'s statistics merged over the line
    xw = torch.randn((2, d, h, h, 8), generator=g, dtype=torch.float64).requires_grad_()
    gamma = (1 + 0.2 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    beta = (0.2 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    dy = torch.randn((2, d, h, h, 8), generator=g, dtype=torch.float64)
    (dy * N.group_norm(xw, 4, gamma, beta)).sum().backward()
    want = [xw.grad[:, mine].clone(), gamma.grad.clone(), beta.grad.clone()]
    gamma.grad = beta.grad = None
    xs = xw.detach()[:, mine].clone().requires_grad_()
    with spatial.partition(line.group, n, r, d, h):
        ys = spatial.group_norm(xs, 4, gamma, beta)
    (dy[:, mine] * ys).sum().backward()
    got = [xs.grad, gamma.grad.clone(), beta.grad.clone()]
    for t in got[1:]:   # the replicated leaves' shares, summed over the line
        dist.all_reduce(t, group=line.group)
    want_y = N.group_norm(xw.detach(), 4, gamma.detach(), beta.detach())[:, mine]
    out["group norm"] = max(_gap(ys, want_y), *(_gap(a, b) for a, b in zip(got, want)))
    return out


def losses() -> dict:
    """Each loss over the slabs against the whole patch: value and the
    gradient of the rank's slab (the losses compute in f32)."""
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = parallel.make_mesh([n], ["sp"])
    g = torch.Generator().manual_seed(3)
    d, h = 8, 4
    dl = d // n
    mine = slice(r * dl, (r + 1) * dl)
    logits = torch.randn((2, d, h, h, 3), generator=g, dtype=torch.float64)
    label = torch.randint(0, 3, (2, d, h, h), generator=g)
    label[1] = label[1].clamp(max=1)   # a sample without class 2: GDL's empty class
    out = {}
    for name, fn in {"dice": L.dice_loss, "focal": L.focal_loss,
                     "cross_entropy": L.cross_entropy_loss,
                     "generalized_dice": L.generalized_dice_loss,
                     "dice_focal": L.dice_focal_loss, "dice_ce": L.dice_ce_loss,
                     "generalized_dice_focal": L.generalized_dice_focal_loss}.items():
        xw = logits.clone().requires_grad_()
        want = fn(xw, label)
        want.backward()
        xs = logits[:, mine].clone().requires_grad_()
        with spatial.partition(mesh.group("sp"), n, r, d, h):
            got = fn(xs, label[:, mine])
            got.backward()
        out[name] = max(_gap(got, want), _gap(xs.grad, xw.grad[:, mine]))
    return out


# the configurations `refusals` builds and steps (the ones SP once refused)
STEPPED = ("fsdp_with_tp", "tensor_parallel", "pipeline_parallel", "unetr", "unet_vanilla",
           "2d")


def refusals() -> dict:
    """What the Trainer says of each configuration SP once refused, on the
    line [world] (None when it builds and steps, else the error's type and
    message: the spatial axis without `spatial_shard` builds, and its step
    raises JAX's `shard_batch` KeyError), and of the field taken without a
    spatial line of more than one rank; of each of `STEPPED`, the loss and
    gradients of one step from the port's own init (`refusal_cases` holds
    them all)."""
    out, stepped = {}, {}
    for name, cfg in refusal_cases(dist.get_world_size()).items():
        out[name] = None
        try:
            trainer = engine.Trainer(Config(**cfg), device="cpu")
            if name in STEPPED or name == "axis_without_flag":
                state = trainer.init_state()
                batch = batch_for(global_batch(cfg))
                state, loss = trainer.train_step(state, batch)
        except (KeyError, NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
            continue
        if name in STEPPED:
            grads = fsdp.gather_full({n: p.grad for n, p in state.params.items()},
                                     trainer.placements)
            stepped[name] = {"loss": float(loss), "sp_top": trainer._sp_top,
                             "grads": {n: g.detach().clone() for n, g in grads.items()}}
    return {"said": out, "stepped": stepped}


def refusal_cases(world: int, *, one_process: bool = False) -> dict:
    """The configurations of `refusals` on the line [world]; `one_process`:
    those of `STEPPED` without the mesh and its modes."""
    unet = MODELS["unet"]
    sp = dict(spatial_shard=True, mesh_shape=[world], mesh_axes=["sp"])
    cases = {
        "fsdp_with_tp": {**unet, "spatial_shard": True, "mesh_shape": [world, 1],
                         "mesh_axes": ["sp", "model"], "tensor_parallel": True, **FSDP_SP},
        "tensor_parallel": {**unet, "spatial_shard": True, "mesh_shape": [world, 1],
                            "mesh_axes": ["sp", "model"], "tensor_parallel": True},
        "pipeline_parallel": {**unet, **sp, "pipeline_parallel": True},
        "unetr": {**unet, **sp, "model_name": "unetr", "feature_size": [4],
                  "hidden_size": 16, "mlp_dim": 32, "num_heads": 2},
        "unet_vanilla": {**unet, **sp, "model_name": "unet_vanilla",
                         "feature_size": [4, 8], "strides": [1, 2]},
        "2d": {**unet, **sp, "spatial_dims": 2},
        "axis_without_flag": {**unet, "mesh_shape": [world], "mesh_axes": ["sp"]},
        "flag_on_data": {**unet, "spatial_shard": True},
    }
    if one_process:
        modes = {*sp, *FSDP_SP, "tensor_parallel", "pipeline_parallel"}
        return {name: {k: v for k, v in cases[name].items() if k not in modes}
                for name in STEPPED}
    return cases


def main(suite: str, rank: int, world: int, rdzv: str, out_dir: str, starts: str) -> None:
    torch.set_num_threads(1)
    start = torch.load(starts, weights_only=True)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    try:
        result = {name: step(name, start[CASES[name][0]]) for name in SUITES[suite]}
        result["fanout"] = fanout()
        result["evaluate"] = evaluate(suite, start["unet"])
        if suite == "sp2":
            result["functions"] = functions()
            result["losses"] = losses()
            result["forward"] = swin_forward("swin", start["swin"])
            result["forward_2d"] = swin_forward("swin_2d", start["swin_2d"])
            result["refusals"] = refusals()
        torch.save(result, Path(out_dir) / f"{suite}_rank{rank}.pt")
    finally:
        parallel.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
         sys.argv[6])
