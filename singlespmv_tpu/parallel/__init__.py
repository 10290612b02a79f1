"""Multi-chip / multi-host parallelism.

The reference is single-node (its only scale-out is SLURM job farming,
/root/reference/script/eval_sbatch.sh); this package is the north-star extension:
matrices row/column-partitioned over a ``jax.sharding.Mesh``, the dense vector's
remote segments exchanged with XLA collectives (``all_gather`` / ``psum`` /
``ppermute``) inside ``shard_map``, which the GPU backend runs through NCCL.
"""
from .mesh import make_mesh, device_count
from .halo import HaloSpMV
from .spmv import DistSpMV, partition_rows_balanced

__all__ = ["make_mesh", "device_count", "DistSpMV", "HaloSpMV",
           "partition_rows_balanced"]
