"""Ranks over ``torch.distributed`` (counterpart of ``simt_tpu/parallel``)."""

from .mesh import (DATA_AXIS, SPATIAL_AXIS, Mesh, RowSharding, all_reduce_,  # noqa: F401
                   all_reduce_sum, barrier, batch_stats_group, fetch_rows, gather_rows,
                   global_batch_stats, initialize_multihost, make_mesh, replicate_state,
                   row_block, row_sharding, shard_batch, shard_rows, spatial_rows,
                   sync_grads, world_size)
