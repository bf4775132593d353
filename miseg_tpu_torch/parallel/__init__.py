"""Parallelism (counterpart of `miseg_tpu/parallel`): the mesh of ranks
and data parallelism, one process a card (`mesh.py`), FSDP (`fsdp.py`),
tensor parallelism (`tensor.py`) and pipeline parallelism, a GPipe over
a line of ranks (`pipeline.py`).  Spatial parallelism waits for ROADMAP
M11."""
from .mesh import (Mesh, active, all_reduce_mean, barrier,  # noqa: F401
                   batch_stats, broadcast_object, broadcast_tensors, data_group,
                   destroy_process_group, group, host_shard_info, init_process_group,
                   is_writer, make_mesh, mesh_from_config)
