"""Multi-chip / multi-host parallelism: batch (DP) and stage (coefficient)
sharding over a jax.sharding.Mesh.

The reference's only parallelism is frame round-robin over replicated FPGA
compute units plus on-chip FIFO pipes (SURVEY.md §2 parallelism table); the
mesh equivalents here are batch sharding (DP), channel sharding of RNS
bases (CH), and coefficient-sharded large-n transforms (SP: a stage-sharded
form whose first/last log2(P) butterfly stages exchange shard halves, and a
four-step form with two all-to-all retiles).
"""

from .fourstep_shard import fourstep_sharded_fwd, fourstep_sharded_inv
from .mesh import ShardedRing, ShardedRNSRing, dp_shard_batch, make_mesh
from .multihost import init_distributed, pod_mesh, process_local_batch
from .stage_shard import stage_sharded_fwd, stage_sharded_inv
