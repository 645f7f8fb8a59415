"""Data-parallel scans over torch.distributed (counterpart of
mixmogam_tpu/parallel): the mesh, multi-process start-up, and the
SNP-sharded kinship and EMMAX, over host rows or a ResidentGenome's packed
shards. The JAX package's snp_sharding and replicated are GSPMD
annotations with no torch counterpart (see parallel/mesh.py);
distributed_train_step raises (ROADMAP Queue 1 item 16e)."""

from mixmogam_tpu_torch.parallel.distributed import (
    distributed_emmax, distributed_emmax_resident, distributed_kinship,
    distributed_train_step, shard_packed_rows)
from mixmogam_tpu_torch.parallel.mesh import Mesh, make_mesh
from mixmogam_tpu_torch.parallel.multihost import (SnpShard,
                                                   initialize_multihost,
                                                   make_global_snp_array)

__all__ = ["make_mesh", "Mesh", "distributed_kinship", "distributed_emmax",
           "distributed_emmax_resident", "shard_packed_rows",
           "distributed_train_step", "initialize_multihost",
           "make_global_snp_array", "SnpShard"]
