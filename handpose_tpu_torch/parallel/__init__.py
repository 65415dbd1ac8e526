"""Data parallelism over a ``torch.distributed`` process group (the
process group is the mesh: see ``mesh.py``), and JAX's dp x tp layout of
the train state over it (``sharding.py``, with its dry run in
``dryrun.py``)."""

from .distributed import (HostShardSampler, all_reduce_sum, gather_rows,
                          initialize_distributed, is_distributed, is_lead,
                          rank, world)
from .mesh import replicate, shard_batch, shard_batch_stacked

__all__ = ["HostShardSampler", "all_reduce_sum", "gather_rows",
           "initialize_distributed", "is_distributed", "is_lead", "rank",
           "world", "replicate", "shard_batch", "shard_batch_stacked"]
