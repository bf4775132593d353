"""Parallelism (counterpart of `miseg_tpu/parallel`): the data-parallel
leg, one process a card (`mesh.py`).  FSDP, tensor, pipeline and spatial
parallelism wait for ROADMAP M11."""
from .mesh import (all_reduce_mean, barrier, batch_stats, broadcast_object,  # noqa: F401
                   broadcast_tensors, check_mesh, destroy_process_group, group,
                   host_shard_info, init_process_group, is_writer)
