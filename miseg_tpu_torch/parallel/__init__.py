"""Parallelism (counterpart of `miseg_tpu/parallel`): the mesh of ranks
and data parallelism, one process a card (`mesh.py`), FSDP (`fsdp.py`),
tensor parallelism (`tensor.py`), pipeline parallelism, a GPipe over
a line of ranks (`pipeline.py`), and spatial partitioning of the
training patch's D over a line of ranks (`spatial.py`)."""
from .mesh import (Mesh, active, all_reduce_mean, barrier,  # noqa: F401
                   batch_stats, broadcast_object, broadcast_tensors, data_group,
                   destroy_process_group, group, host_shard_info, init_process_group,
                   is_writer, make_mesh, mesh_from_config)
from .spatial import shard_spatial_batch, spatial_spec  # noqa: F401
