"""Data-parallel scans over torch.distributed (counterpart of
mixmogam_tpu/parallel): the mesh, multi-process start-up, the SNP-sharded
kinship and EMMAX over host rows or a ResidentGenome's packed shards, and
distributed_train_step, the end-to-end multi-trait step (kinship, eigh and
batched REML, a K3 scan a trait, one top-k gather). dryrun.py holds the
twins of __graft_entry__.py's entry points (entry, dryrun_multichip).
The JAX package's snp_sharding and replicated are GSPMD annotations with
no torch counterpart (see parallel/mesh.py)."""

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
