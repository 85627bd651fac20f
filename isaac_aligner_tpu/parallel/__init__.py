"""Multi-device sharding: mesh construction, index sharding, SPMD pipeline.

The device replacement for the reference's single-node thread
parallelism (SURVEY.md §2.14/§5.8): reads are data-parallel over a
`data` mesh axis, the sorted k-mer index is range-sharded over a `shard`
mesh axis, and candidate hits are combined with XLA collectives.
"""

from .sharded import ShardedIndexArrays, make_mesh, shard_index, sharded_align  # noqa: F401
from .sharded_aligner import ShardedAligner, ShardedPairedAligner  # noqa: F401
