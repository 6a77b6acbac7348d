"""Grid-sharded execution of the compaction pipeline — counterpart of
``rocksplicator_tpu/parallel``.

The "shard" grid axis is the DP-analog (independent shards compact in
parallel) and the "block" axis the SP-analog (one shard's entry stream
split blockwise across devices, merged after a gather).
"""

from .mesh import make_mesh, sharded_compaction_step

__all__ = ["make_mesh", "sharded_compaction_step"]
