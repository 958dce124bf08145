"""Ranks over ``torch.distributed`` (counterpart of ``simt_tpu/parallel``)."""

from .mesh import (DATA_AXIS, SPATIAL_AXIS, Mesh, all_reduce_, all_reduce_sum,  # noqa: F401
                   barrier, batch_stats_group, global_batch_stats, initialize_multihost,
                   make_mesh, replicate_state, shard_batch, sync_grads, world_size)
