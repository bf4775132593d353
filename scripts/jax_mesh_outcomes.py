"""What the JAX package's Trainer does on each mesh composition: one train
step of the tiny C-UNETR or swin of `tests/_torch_mesh_worker.py` on XLA
host devices, printed as "steps, loss L" or "raises E: message".

    JAX_PLATFORMS=cpu python scripts/jax_mesh_outcomes.py [NAME ...]

The compositions are the ones the port once refused and the overlaps of
two modes on one axis (ROADMAP D13 records the outcomes); the port's
tests hold the port to each (`tests/test_torch_pipeline.py`,
`tests/test_torch_spatial.py`).  Runs on 8 host devices, each case on
the first `prod(mesh_shape)` of them; ~10 min for all on one CPU core.
"""

import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402
from miseg_tpu.config import Config  # noqa: E402
from miseg_tpu.train.engine import Trainer  # noqa: E402
from miseg_tpu.utils.logging import MetricLogger  # noqa: E402


# name -> (model, global batch, mesh and mode fields)
CASES = {
    "one device": ("unetr", 2, dict(mesh_shape=[1], mesh_axes=["data"])),
    "one device, batch 4": ("unetr", 4, dict(mesh_shape=[1], mesh_axes=["data"])),
    "swin one device": ("swin", 2, dict(mesh_shape=[1], mesh_axes=["data"])),
    "axis 'sp' without spatial_shard [2]": ("unetr", 2, dict(mesh_shape=[2],
                                                             mesh_axes=["sp"])),
    "axis 'sp' without spatial_shard [1]": ("unetr", 2, dict(mesh_shape=[1],
                                                             mesh_axes=["sp"])),
    "data x copies [1, 2]": ("unetr", 2, dict(mesh_shape=[1, 2], mesh_axes=["data", "copies"])),
    "data x copies [2, 2]": ("unetr", 2, dict(mesh_shape=[2, 2], mesh_axes=["data", "copies"])),
    "tp on 'model' [2], no 'data'": ("unetr", 2, dict(mesh_shape=[2], mesh_axes=["model"],
                                                      tensor_parallel=True)),
    "pp [4], no 'data'": ("unetr", 2, dict(mesh_shape=[4], mesh_axes=["pp"],
                                           pipeline_parallel=True)),
    "tp over data [2]": ("unetr", 2, dict(mesh_shape=[2], mesh_axes=["data"],
                                          tensor_parallel=True, tp_axis="data")),
    "tp over data [4], batch 4": ("unetr", 4, dict(mesh_shape=[4], mesh_axes=["data"],
                                                   tensor_parallel=True, tp_axis="data")),
    "tp + fsdp over data [2]": ("swin", 2, dict(mesh_shape=[2], mesh_axes=["data"],
                                                tensor_parallel=True, tp_axis="data",
                                                **W.fsdp_on("data"))),
    "pp over data [2, 2]": ("unetr", 2, dict(mesh_shape=[2, 2], mesh_axes=["data", "model"],
                                             pipeline_parallel=True, pp_axis="data")),
    "pp over data [2, 2], 1 microbatch": ("unetr", 2, dict(
        mesh_shape=[2, 2], mesh_axes=["data", "model"], pipeline_parallel=True,
        pp_axis="data", pp_microbatches=1)),
    "spatial axis 'data' [2]": ("unetr", 2, dict(mesh_shape=[2], spatial_shard=True,
                                                 spatial_axis="data")),
    "sp x tp [1, 2, 2]": ("unetr", 2, W.sp([1, 2, 2], "model", tensor_parallel=True)),
    "swin sp x tp [1, 2, 2]": ("swin", 2, W.sp([1, 2, 2], "model", tensor_parallel=True)),
    "swin sp x tp + fsdp on model": ("swin", 2, W.sp([1, 2, 2], "model", tensor_parallel=True,
                                                   **W.fsdp_on("model"))),
    "sp x pp [1, 2, 2]": ("unetr", 2, W.sp([1, 2, 2], "pp", pipeline_parallel=True)),
    "swin sp x pp [1, 2, 4]": ("swin", 2, W.sp([1, 2, 4], "pp", pipeline_parallel=True)),
    "data x sp x copies [1, 2, 2]": ("unetr", 2, W.sp([1, 2, 2], "model")),
    "sp + fsdp on copies": ("unetr", 2, W.sp([1, 2, 2], "model", **W.fsdp_on("model"))),
    "sp x pp + fsdp on pp": ("unetr", 2, W.sp([1, 2, 2], "pp", pipeline_parallel=True,
                                            **W.fsdp_on("pp"))),
    "tp on the spatial axis": ("unetr", 2, dict(mesh_shape=[1, 2], mesh_axes=["data", "sp"],
                                                spatial_shard=True, tensor_parallel=True,
                                                tp_axis="sp")),
    "pp on the spatial axis": ("unetr", 2, dict(mesh_shape=[1, 2], mesh_axes=["data", "sp"],
                                                spatial_shard=True, pipeline_parallel=True,
                                                pp_axis="sp")),
    "pp on the spatial axis, no 'data'": ("unetr", 2, dict(
        mesh_shape=[2, 2], mesh_axes=["sp", "pp"], spatial_shard=True,
        pipeline_parallel=True)),
    "pp on the tp axis": ("unetr", 2, dict(mesh_shape=[1, 2], mesh_axes=["data", "model"],
                                           tensor_parallel=True, pipeline_parallel=True,
                                           pp_axis="model")),
    "sp x tp over data [2, 2]": ("unetr", 2, dict(mesh_shape=[2, 2], mesh_axes=["data", "sp"],
                                                  spatial_shard=True, tensor_parallel=True,
                                                  tp_axis="data")),
}


def outcome(model: str, size: int, par: dict) -> str:
    cfg = dict(W.MODELS[model], **par)
    shape = cfg["mesh_shape"]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                tuple(cfg["mesh_axes"]) if "mesh_axes" in cfg else ("data",))
    batch = W.global_batches(cfg, 1, size=size)[0]
    try:
        trainer = Trainer(Config(**cfg), mesh=mesh, workdir=tempfile.mkdtemp(),
                          logger=MetricLogger(None))
        state = trainer.init_state(batch["image"][:1], batch["modality"][:1])
        _, loss = trainer.train_step(state, batch)
        return f"steps, loss {float(loss):.8f}"
    except Exception as e:  # noqa: BLE001 -- the outcome is what is printed
        return f"raises {type(e).__name__}: {str(e)[:240]}"


if __name__ == "__main__":
    for name in sys.argv[1:] or CASES:
        print(f"{name}: {outcome(*CASES[name])}", flush=True)
