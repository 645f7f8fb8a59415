"""Float64 numpy oracle pieces the port needs on its own paths: the
kinship constructions behind kinship(use_device=False), scale_k and
prepare_k (copies of mixmogam_tpu/oracle/kinship.py, pinned by
tests/test_torch_datalayer.py)."""

from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, mean_impute,
                                               prepare_k, scale_k,
                                               vanraden_kinship)

__all__ = ["ibs_kinship", "vanraden_kinship", "scale_k", "prepare_k",
           "mean_impute"]
