"""State carried over from the JAX package as numpy arrays.

The JAX package's NullModel / RotatedNull / ResidentGenome hold jax
arrays; pass their fields through np.asarray and these constructors build
the port's counterparts on `device`, so that both packages can be fed the
same null model, the same int8 digit planes and the same packed rows (and
the class facade, the same LinearMixedModel state). Its
host objects (GenotypeData / DosageData, PhenotypeData, Result,
GwasConfig) are carried across from their numpy and Python fields, read
by attribute: nothing of the JAX package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, device, dtype=None):
    # np.array copies: a jax array's numpy view is read-only
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def null_from_numpy(phi, U, delta, log_delta, ll, sigma_g2, sigma_e2,
                    pseudo_heritability, y, X0, device="cpu",
                    dtype=torch.float64, ml=False):
    """NullModel from the fields of a fitted (JAX) null model; ml: the
    objective it was fitted with (the JAX NullModel's _ml attribute)."""
    from mixmogam_tpu_torch.ops.reml import NullModel

    X0 = np.asarray(X0)
    if X0.ndim == 1:
        X0 = X0[:, None]
    return NullModel(
        phi=_t(phi, device, dtype), U=_t(U, device, dtype),
        delta=_t(delta, device, dtype), log_delta=_t(log_delta, device,
                                                     dtype),
        ll=_t(ll, device, dtype), sigma_g2=_t(sigma_g2, device, dtype),
        sigma_e2=_t(sigma_e2, device, dtype),
        pseudo_heritability=_t(pseudo_heritability, device, dtype),
        y=_t(y, device, dtype).reshape(-1), X0=_t(X0, device, dtype),
        ml=bool(ml))


def linear_mixed_model_from_fields(Y, X, K=None, eig_k=None,
                                   device=None):
    """The port's compat.LinearMixedModel in the state read by attribute
    from a JAX LinearMixedModel (Y, X, K, _eig_k): Y and X as float64
    host arrays, K and its (phi, U) as float64 tensors on `device` (the
    card unless 'cpu' is asked for, as LinearMixedModel's own). The REML
    cache starts empty."""
    from mixmogam_tpu_torch.compat import LinearMixedModel

    lmm = LinearMixedModel(np.asarray(Y, dtype=np.float64), device=device)
    lmm.X = np.array(X, dtype=np.float64)
    if K is not None:
        lmm.add_random_effect(np.array(K, dtype=np.float64))
    if eig_k is not None:
        lmm._eig_k = tuple(_t(a, lmm.device, torch.float64) for a in eig_k)
    return lmm


def rotated_null_from_numpy(W, sd, Q0, y_res, rss0, dof, w_scale=None,
                            device="cpu", dtype=torch.float64):
    """RotatedNull from the JAX fields. An int8 W (K, n, n) is taken as
    the digit planes, unchanged; a bfloat16 W (ml_dtypes) is taken as the
    split-W parts: (K, n, n) stacked, (n, K*n) concat ('bf16xKc') or
    (n, n) for the 1-pass 'bf16' tier (bf16 -> float32 -> bf16 is exact);
    a float W = U * sd (the exact tier) becomes the port's U = W / sd,
    since the port whitens inside the scan kernel."""
    from mixmogam_tpu_torch.ops.scan import RotatedNull

    W = np.asarray(W)
    sd_t = _t(sd, device, dtype)
    planes = U = parts = None
    if W.dtype == np.int8:
        planes = _t(W, device)
    elif W.dtype.name == "bfloat16":
        n = sd_t.shape[0]
        P = W.astype(np.float32)
        if P.ndim == 2:
            P = P.reshape(n, -1, n).transpose(1, 0, 2)
        parts = _t(P, device, torch.bfloat16)
    else:
        U = _t(W, device, dtype) / sd_t[None, :]
    Q0 = np.asarray(Q0)
    if Q0.ndim == 1:
        Q0 = Q0[:, None]
    return RotatedNull(
        sd=sd_t, Q0=_t(Q0, device, dtype), y_res=_t(y_res, device, dtype),
        rss0=_t(rss0, device, dtype), dof=_t(dof, device, dtype), U=U,
        planes=planes, parts=parts,
        w_scale=None if w_scale is None else _t(w_scale, device, dtype))


def trait_nulls_from_numpy(sd, X0s, y_res, rss0, dof, device="cpu",
                           dtype=torch.float64):
    """Per-trait RotatedNulls from the fields of the JAX package's
    multi-trait _trait_nulls: sd (T, n), the whitened designs X0s
    (T, n, q), y_res (T, n), rss0 (T,) and dof. GxE's per-environment nulls
    (sds, Q0s, y_ress, rss0s of the JAX emmax_gxe) come over the same way:
    their Q0 is already orthonormal, and passed as X0s it comes back as
    itself up to rounding. The JAX epilogue solves
    with the Cholesky factor of X0s_t' X0s_t; K3 takes an orthonormal Q0,
    so Q0_t is the orthonormal basis of X0s_t (ops/eigen.py
    orthonormal_basis): xx = ss - c'A^-1 c = ss - |Q0_t' x|^2."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis
    from mixmogam_tpu_torch.ops.scan import RotatedNull

    sd, X0s = np.asarray(sd), np.asarray(X0s)
    y_res, rss0 = np.asarray(y_res), np.asarray(rss0)
    return [RotatedNull(sd=_t(sd[t], device, dtype),
                        Q0=orthonormal_basis(_t(X0s[t], device, dtype)),
                        y_res=_t(y_res[t], device, dtype),
                        rss0=_t(rss0[t], device, dtype),
                        dof=_t(dof, device, dtype))
            for t in range(sd.shape[0])]


def gblup_model_from_fields(model, device="cpu"):
    """The port's GblupModel from a fitted (JAX) gBLUP model's fields:
    beta, u_hat and fitted as float64 host arrays, the internals that
    predict() and reliability() read as float64 tensors on `device`."""
    from mixmogam_tpu_torch.models.gblup import GblupModel

    host = {k: np.array(getattr(model, k), dtype=np.float64)
            for k in ("beta", "u_hat", "fitted")}
    dev = {k: _t(getattr(model, k), device, torch.float64)
           for k in ("_hinv_r", "_X0", "_phi", "_U")}
    return GblupModel(delta=float(model.delta),
                      sigma_g2=float(model.sigma_g2),
                      sigma_e2=float(model.sigma_e2),
                      pseudo_heritability=float(model.pseudo_heritability),
                      **host, **dev)


def resident_from_packed(host_packed, M, n, ploidy, tile, has_missing,
                         device="cpu", upload: bool = True):
    """ResidentGenome from packed host rows (M_pad, ceil(n/4)) uint8 (a
    JAX container's host_packed, or its packed when it was built with
    upload=False: both are numpy then). upload=False gives a host-only
    container, as from_source(upload=False) does."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome

    hp = np.array(host_packed, dtype=np.uint8, order="C")
    return ResidentGenome(torch.from_numpy(hp).to(device) if upload else hp,
                          M, n, ploidy, tile, has_missing, host_packed=hp)


def genotype_from_fields(gd):
    """The port's GenotypeData (or DosageData, for a float matrix) from
    any object with the JAX container's fields."""
    from mixmogam_tpu_torch.data.genotype import DosageData, GenotypeData

    mat = np.asarray(gd.matrix)
    cls = DosageData if np.issubdtype(mat.dtype, np.floating) \
        else GenotypeData
    return cls(matrix=np.array(mat), chromosomes=np.array(gd.chromosomes),
               positions=np.array(gd.positions),
               accessions=list(gd.accessions), ploidy=int(gd.ploidy),
               alleles=None if gd.alleles is None else np.array(gd.alleles))


def phenotype_from_fields(phend):
    """The port's PhenotypeData from the JAX container's phen_dict (names,
    ecotypes, values, transformation and the raw values)."""
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData

    out = PhenotypeData()
    for pid, p in phend.phen_dict.items():
        out.add_phenotype(pid, p.name, p.ecotypes, p.values)
        q = out.phen_dict[pid]
        q.transformation = p.transformation
        q.raw_values = None if p.raw_values is None else list(p.raw_values)
    return out


def result_from_fields(res):
    """The port's Result from the JAX Result's arrays."""
    from mixmogam_tpu_torch.results.result import Result

    return Result(np.array(res.scores), np.array(res.chromosomes),
                  np.array(res.positions),
                  mafs=None if res.mafs is None else np.array(res.mafs),
                  macs=None if res.macs is None else np.array(res.macs),
                  additional={k: np.array(v)
                              for k, v in res.additional.items()},
                  score_type=res.score_type)


def config_from_fields(cfg):
    """The port's GwasConfig from the JAX GwasConfig: the REML, filter,
    mesh and precision settings carry over; of the tiles only the kinship
    block does (the scan tile stays the port's own default)."""
    import dataclasses

    from mixmogam_tpu_torch import config as C

    def carry(cls, src, **override):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: getattr(src, k) for k in names if hasattr(src, k)}
        kw.update(override)
        return cls(**kw)

    return C.GwasConfig(
        reml=carry(C.RemlConfig, cfg.reml),
        filters=carry(C.FilterConfig, cfg.filters),
        tiles=carry(C.TileConfig, cfg.tiles,
                    scan_snp_tile=C.TileConfig().scan_snp_tile),
        mesh=carry(C.MeshConfig, cfg.mesh),
        precision=carry(C.PrecisionConfig, cfg.precision))
