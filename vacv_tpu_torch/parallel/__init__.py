from .mesh import DATA_AXIS, batch_sharding, init_distributed, local_device, make_mesh, replicated
from .pipeline import put_sharded, shard_batched, shard_batched_with_stats
