"""X-explicit REML in the kinship eigenbasis (counterpart of
mixmogam_tpu/ops/xreml.py: chol_small, chol_solve_small, inv_small,
chol_logdet_small, _ll_from_moments, ll_explicit, explicit_reml, and the
per-SNP half: _snp_moments, _assemble, _ll_snps_at, emma_delta_scan).

In eigh(K)'s basis H = K + delta I is diagonal, so the (RE)ML likelihood
of one design X reduces to weighted moments of the rotated data, with
w = 1/(phi + delta): A = X'WX, b = X'Wy, c = y'Wy, and O(p^2) algebra:

  LL_R(d) = 1/2 [ (n-p)(ln((n-p)/2pi) - 1 - ln yPy)
                  - ( ln|H| + ln|X'H^-1 X| - ln|X'X| ) ],  yPy = c - b'A^-1 b.

explicit_reml maximizes it over log delta: dLL/dlog delta on a grid,
bisection in every +/- bracket, the argmax of LL over the refined roots and
both ends of the grid. It is the null fit of every entry point
(ops/reml.py::fit_null_model) and stepwise's per-step re-fit (REML and
ML). Everything runs in float64 on the data's device; the grid, and the
bisection of all brackets, each evaluate their points as one batch.

dLL/dlog delta is the analytic derivative (JAX takes it by autodiff):
0.5 d (scale |Py|^2 / yPy - tr P) with Py = W (y - X beta) and tr P =
sum w - tr(A^-1 X'W^2 X) (REML) or sum w (ML);
tests/test_torch_xreml.py holds its signs on the grid to JAX's.

emma_delta_scan is EMMA's per-SNP REML: every SNP j of a tile has its own
design [X0 | g_j] and its own delta. The grid's weights are shared by all
SNPs, so the grid is two products a block of grid points (_grid_lls):
the rotated rows times the block's [W0_k | w_k y] side by side, and their
squares times its w_k. The bisection's weights are per SNP, (m, n), and
its derivative is the same analytic form per SNP (_dll_snps_at), with no
autograd graph (tests/test_torch_emma.py holds it to autograd of
_ll_snps_at and to the JAX package's jax.grad). emma_grid and emma_refine
are the scan's two stages, which models/emma.py times apart.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# ---------------------------------------------------------------------------
# small-matrix linear algebra, batched over leading dimensions
# ---------------------------------------------------------------------------


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of (..., p, p) symmetric matrices, column by column
    with each pivot clamped at the dtype's tiny, so a semi-definite A gives
    finite factors (the JAX package's rule; torch.linalg.cholesky raises)."""
    p = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    L = torch.zeros_like(A)
    for j in range(p):
        s = A[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(dim=-1)
        L[..., j, j] = torch.sqrt(torch.clamp(s, min=tiny))
        if j + 1 < p:
            col = A[..., j + 1:, j] - (L[..., j + 1:, :j]
                                       @ L[..., j, :j, None])[..., 0]
            L[..., j + 1:, j] = col / L[..., j, j, None]
    return L


def chol_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b, given L = chol_small(A); b is (..., p)."""
    p = L.shape[-1]
    # numpy's broadcast_shapes: torch's imports sympy at its first call
    # (seconds, once per process)
    y = torch.zeros(np.broadcast_shapes(tuple(L.shape[:-1]), tuple(b.shape)),
                    dtype=L.dtype, device=L.device)
    for i in range(p):
        y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(dim=-1)
                     ) / L[..., i, i]
    x = torch.zeros_like(y)
    for i in reversed(range(p)):
        x[..., i] = (y[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]
                                  ).sum(dim=-1)) / L[..., i, i]
    return x


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., p, p) symmetric positive definite matrices through
    chol_small (every unit vector solved as one batch)."""
    p = A.shape[-1]
    L = chol_small(A)
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    # row i of the result solves A x = e_i: A^-1 is symmetric
    return chol_solve_small(L[..., None, :, :], eye)


def chol_logdet_small(L: torch.Tensor) -> torch.Tensor:
    """log|A| from L = chol_small(A)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)


# ---------------------------------------------------------------------------
# the likelihood of one design from weighted moments
# ---------------------------------------------------------------------------

def _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n: int, p: int,
                     reml: bool):
    """(RE)ML log-likelihood, yPy and beta from A = X'H^-1X (..., p, p),
    b = X'H^-1y (..., p), c = y'H^-1y (...) and the log-determinants."""
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = torch.clamp(c - (b * beta).sum(dim=-1),
                      min=torch.finfo(c.dtype).tiny)
    if reml:
        scale = n - p
        logdet = logdet_H + chol_logdet_small(L) - logdet_XtX
    else:
        scale = n
        logdet = logdet_H
    ll = 0.5 * (scale * (math.log(scale / (2.0 * math.pi)) - 1.0
                         - torch.log(ypy)) - logdet)
    return ll, ypy, beta


def _moments(d: torch.Tensor, phi, y_rot, X_rot):
    """w (..., n), A (..., p, p), b (..., p), c (...) at delta d (...)."""
    w = 1.0 / (phi + d[..., None])
    Xw = X_rot * w[..., :, None]
    A = X_rot.T @ Xw
    b = (Xw * y_rot[:, None]).sum(dim=-2)
    c = (w * y_rot * y_rot).sum(dim=-1)
    return w, Xw, A, b, c


def ll_explicit(logdelta, phi, y_rot, X_rot, reml: bool = True
                ) -> torch.Tensor:
    """LL of ONE design X_rot (n, p) at log delta (scalar or batched);
    y_rot = U'y and X_rot = U'X in the kinship's eigenbasis."""
    logdelta = torch.as_tensor(logdelta, dtype=phi.dtype, device=phi.device)
    d = torch.exp(logdelta)
    n, p = X_rot.shape
    _, _, A, b, c = _moments(d, phi, y_rot, X_rot)
    logdet_H = torch.log(phi + d[..., None]).sum(dim=-1)
    logdet_XtX = chol_logdet_small(chol_small(X_rot.T @ X_rot))
    ll, _, _ = _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n, p, reml)
    return ll


def dll_explicit(logdelta, phi, y_rot, X_rot, reml: bool = True
                 ) -> torch.Tensor:
    """dLL/dlog delta of one design at log delta (scalar or batched)."""
    logdelta = torch.as_tensor(logdelta, dtype=phi.dtype, device=phi.device)
    d = torch.exp(logdelta)
    n, p = X_rot.shape
    w, Xw, A, b, c = _moments(d, phi, y_rot, X_rot)
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = torch.clamp(c - (b * beta).sum(dim=-1),
                      min=torch.finfo(c.dtype).tiny)
    Py = w * (y_rot - beta @ X_rot.T)
    tr = w.sum(dim=-1)
    if reml:
        # tr(A^-1 X'W^2X), both symmetric
        tr = tr - (inv_small(A) * (Xw.transpose(-1, -2) @ Xw)).sum(
            dim=(-1, -2))
    scale = (n - p) if reml else n
    return 0.5 * d * (scale * (Py * Py).sum(dim=-1) / ypy - tr)


def explicit_reml(phi, y_rot, X_rot, ngrids: int = 100, llim: float = -10.0,
                  ulim: float = 10.0, refine_iters: int = 32,
                  reml: bool = True) -> Dict[str, torch.Tensor]:
    """Single-design REML (reml=True) or ML: grid of ngrids + 1 points in
    log delta, refine_iters bisections of every bracket where dLL changes
    from + to -, argmax of LL over the roots and both ends. phi (n,),
    y_rot (n,) and X_rot (n, p) are float64 tensors on one device; the
    result's values are 0-d tensors there (beta (p,))."""
    dt, dev = phi.dtype, phi.device
    if X_rot.ndim == 1:
        X_rot = X_rot[:, None]
    grid = torch.linspace(llim, ulim, ngrids + 1, dtype=dt, device=dev)
    dll = dll_explicit(grid, phi, y_rot, X_rot, reml)
    idx = torch.nonzero((dll[:-1] > 0) & (dll[1:] < 0))[:, 0]
    lo, hi = grid[idx], grid[idx + 1]
    if idx.numel():
        for _ in range(refine_iters):
            mid = (lo + hi) / 2.0
            up = dll_explicit(mid, phi, y_rot, X_rot, reml) > 0
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    ends = torch.tensor([llim, ulim], dtype=dt, device=dev)
    cands = torch.cat([(lo + hi) / 2.0, ends])
    lls = ll_explicit(cands, phi, y_rot, X_rot, reml)
    j = torch.argmax(lls)
    log_delta = cands[j]
    delta = torch.exp(log_delta)
    n, p = X_rot.shape
    _, _, A, b, c = _moments(delta, phi, y_rot, X_rot)
    beta = chol_solve_small(chol_small(A), b)
    ypy = c - (b * beta).sum()
    sg2 = ypy / ((n - p) if reml else n)
    return {"log_delta": log_delta, "delta": delta, "ll": lls[j],
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta), "beta": beta}


# ---------------------------------------------------------------------------
# per-SNP EMMA: the grid as shared products, then a bisection per SNP in
# the grid argmax's bracket and in the best bracket that does not adjoin it
# ---------------------------------------------------------------------------

def _snp_moments(Gt, X0_rot, y_rot, w):
    """Weighted moments of the designs [X0 | g_j], one SNP per row of Gt
    (m, n): (A00, b0, c, a01, a11, b1). w (n,) is shared by every SNP
    (A00 (q, q), b0 (q,), c 0-d), or w (m, n) is per SNP (A00 (m, q, q),
    b0 (m, q), c (m,)); a01 (m, q), a11 and b1 (m,) either way."""
    q = X0_rot.shape[1]
    if w.ndim == 1:
        W0 = X0_rot * w[:, None]
        P = Gt @ torch.cat([W0, (w * y_rot)[:, None]], dim=1)
        return (X0_rot.T @ W0, W0.T @ y_rot, (w * y_rot * y_rot).sum(),
                P[:, :q], (Gt * Gt) @ w, P[:, q])
    n = X0_rot.shape[0]
    WG = w * Gt
    # the per-SNP null blocks in one product: X0_i X0_i', y_i X0_i, y_i^2
    V = torch.cat([(X0_rot[:, :, None] * X0_rot[:, None, :]).reshape(n, q * q),
                   X0_rot * y_rot[:, None], (y_rot * y_rot)[:, None]], dim=1)
    S = w @ V
    P = WG @ torch.cat([X0_rot, y_rot[:, None]], dim=1)
    return (S[:, :q * q].reshape(-1, q, q), S[:, q * q:q * q + q],
            S[:, -1], P[:, :q], (WG * Gt).sum(dim=1), P[:, q])


def _assemble_gram(A00, a01, a11):
    """[[A00, a01], [a01', a11]] (..., p, p) over a11's batch shape; a
    shared A00 (q, q), or (k, q, q) for k grid points against a11 (m, k),
    broadcasts to it."""
    q = a01.shape[-1]
    top = torch.cat([A00.expand(a11.shape + (q, q)), a01[..., :, None]],
                    dim=-1)
    bot = torch.cat([a01, a11[..., None]], dim=-1)[..., None, :]
    return torch.cat([top, bot], dim=-2)


def _assemble(A00, b0, c, a01, a11, b1):
    """Blocks -> A (..., p, p), b (..., p), c (...) with p = q + 1, over
    a11's batch shape (shared blocks broadcast, as in _assemble_gram)."""
    batch = a11.shape
    b = torch.cat([b0.expand(batch + b0.shape[-1:]), b1[..., None]], dim=-1)
    return _assemble_gram(A00, a01, a11), b, c.expand(batch)


def _ll_snps_at(logdelta, Gt, X0_rot, y_rot, phi, logdet_XtX, reml: bool):
    """(ll, ypy, beta) per SNP at per-SNP log delta (m,): the likelihood
    the bisection's candidates are compared on (autograd-differentiable
    in logdelta)."""
    d = torch.exp(logdelta)[:, None]
    w = 1.0 / (phi[None, :] + d)
    A, b, c = _assemble(*_snp_moments(Gt, X0_rot, y_rot, w))
    n, p = phi.shape[0], X0_rot.shape[1] + 1
    logdet_H = torch.log(phi[None, :] + d).sum(dim=1)
    return _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n, p, reml)


def _dll_snps_at(logdelta, Gt, X0_rot, y_rot, phi, reml: bool):
    """dLL/dlog delta per SNP at per-SNP log delta (m,), analytically:
    0.5 d (scale |Py|^2 / yPy - tr P), Py = W (y - X beta), tr P = sum w -
    tr(A^-1 X'W^2X) (REML) or sum w (ML), as dll_explicit for one design."""
    d = torch.exp(logdelta)[:, None]
    w = 1.0 / (phi[None, :] + d)
    A, b, c = _assemble(*_snp_moments(Gt, X0_rot, y_rot, w))
    n, q = X0_rot.shape
    p = q + 1
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = torch.clamp(c - (b * beta).sum(dim=-1), min=torch.finfo(c.dtype).tiny)
    Py = w * (y_rot[None, :] - beta[:, :q] @ X0_rot.T - beta[:, q:] * Gt)
    tr = w.sum(dim=1)
    if reml:
        # tr(A^-1 X'W^2X), both symmetric
        A00, _, _, a01, a11, _ = _snp_moments(Gt, X0_rot, y_rot, w * w)
        tr = tr - (inv_small(A) * _assemble_gram(A00, a01, a11)).sum(
            dim=(-1, -2))
    scale = (n - p) if reml else n
    return 0.5 * d[:, 0] * (scale * (Py * Py).sum(dim=1) / ypy - tr)


#: batch elements (SNP x grid point x p^2) of one chunk of _grid_lls's
#: assembled A: a wide design evaluates the grid a few points at a time
_GRID_CHUNK_ELEMS = 1 << 26
#: grid points of one product: a chunk's products run a block of this many
#: points at a time, blocks counted from the grid's start, so a point's LL
#: comes from the same products, bit for bit, however the grid is chunked
#: (a BLAS may round a column differently as the product's width changes)
_GRID_BLOCK = 8


def _grid_lls(Gt, X0_rot, y_rot, phi, logdet_XtX, grid, reml: bool):
    """(m, k) LL of every SNP at every grid point log delta (k,): the
    grid's shared weights w_k stacked side by side, so each block of
    _GRID_BLOCK grid points takes two products, Gt @ [W0_k | w_k y]_k and
    (Gt * Gt) @ w^T; a chunk holds whole blocks."""
    m, n = Gt.shape
    q = X0_rot.shape[1]
    p = q + 1
    G2 = Gt * Gt
    step = max(1, _GRID_CHUNK_ELEMS // max(m * p * p, 1))
    step = max(_GRID_BLOCK, step - step % _GRID_BLOCK)
    out = []
    for s in range(0, grid.shape[0], step):
        d = torch.exp(grid[s:s + step])
        blocks = range(0, d.shape[0], _GRID_BLOCK)
        w = 1.0 / (phi[None, :] + d[:, None])                   # (k, n)
        W0 = X0_rot[None, :, :] * w[:, :, None]                 # (k, n, q)
        V = torch.cat([W0, (w * y_rot[None, :])[:, :, None]], dim=2)
        P = torch.cat([(Gt @ V[j:j + _GRID_BLOCK].permute(1, 0, 2)
                        .reshape(n, -1)).reshape(m, -1, p)
                       for j in blocks], dim=1)
        G2w = torch.cat([G2 @ w[j:j + _GRID_BLOCK].T.contiguous()
                         for j in blocks], dim=1)
        A, b, c = _assemble(X0_rot.T @ W0, (W0 * y_rot[None, :, None]).sum(1),
                            (w * y_rot * y_rot).sum(dim=1), P[..., :q],
                            G2w, P[..., q])
        logdet_H = torch.log(phi[None, :] + d[:, None]).sum(dim=1)
        ll, _, _ = _ll_from_moments(A, b, c, logdet_H, logdet_XtX[:, None],
                                    n, p, reml)
        out.append(ll)
    return torch.cat(out, dim=1)


def emma_grid(Gt, X0_rot, y_rot, phi, logdet_XtX_all, ngrids: int = 100,
              llim: float = -10.0, ulim: float = 10.0, reml: bool = True):
    """The scan's first stage: (grid, k1, k2), the ngrids + 1 grid points,
    each SNP's grid argmax k1 and its best point k2 not adjoining k1."""
    dev = Gt.device
    grid = torch.linspace(llim, ulim, ngrids + 1, dtype=y_rot.dtype,
                          device=dev)
    lls_grid = _grid_lls(Gt, X0_rot, y_rot, phi, logdet_XtX_all, grid,
                         reml)
    k1 = torch.argmax(lls_grid, dim=1)
    idx = torch.arange(ngrids + 1, device=dev)
    far = (idx[None, :] - k1[:, None]).abs() > 1
    k2 = torch.argmax(torch.where(far, lls_grid, -torch.inf), dim=1)
    return grid, k1, k2


def emma_refine(Gt, X0_rot, y_rot, phi, logdet_XtX_all, grid, k1, k2,
                refine_iters: int = 32, reml: bool = True
                ) -> Dict[str, torch.Tensor]:
    """The scan's second stage: refine_iters bisections on the sign of dLL
    in the brackets around k1 and k2 (lo moves to mid where dLL(mid) > 0),
    then the best of three candidates per SNP: the grid argmax first, then
    the two refined points; a NaN candidate never wins."""
    ngrids = grid.shape[0] - 1
    # the last bracket's width: a bisection that ends this close to its
    # grid point has found the grid point itself (a maximum at the grid's
    # edge, where dLL keeps one sign); it returns that point exactly, whose
    # LL ties the grid candidate's, so no comparison of two LLs that differ
    # by rounding alone decides between them (two devices pick alike)
    last = (grid[-1] - grid[0]) / max(ngrids, 1) / 2.0 ** refine_iters

    def refine(k):
        lo = grid[torch.clamp(k - 1, min=0)]
        hi = grid[torch.clamp(k + 1, max=ngrids)]
        for _ in range(refine_iters):
            mid = (lo + hi) / 2.0
            up = _dll_snps_at(mid, Gt, X0_rot, y_rot, phi, reml) > 0
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
        root = (lo + hi) / 2.0
        return torch.where((root - grid[k]).abs() <= last, grid[k], root)

    cands = [grid[k1], refine(k1), refine(k2)]
    log_delta = cands[0]
    ll, ypy, beta = _ll_snps_at(log_delta, Gt, X0_rot, y_rot, phi,
                                logdet_XtX_all, reml)
    for c in cands[1:]:
        ll_c, ypy_c, beta_c = _ll_snps_at(c, Gt, X0_rot, y_rot, phi,
                                          logdet_XtX_all, reml)
        take = (ll_c > ll) | (torch.isnan(ll) & ~torch.isnan(ll_c))
        log_delta = torch.where(take, c, log_delta)
        ypy = torch.where(take, ypy_c, ypy)
        beta = torch.where(take[:, None], beta_c, beta)
        ll = torch.where(take, ll_c, ll)
    return {"log_delta": log_delta, "delta": torch.exp(log_delta), "ll": ll,
            "ypy": ypy, "beta": beta}


def emma_delta_scan(Gt, X0_rot, y_rot, phi, logdet_XtX_all,
                    ngrids: int = 100, llim: float = -10.0,
                    ulim: float = 10.0, refine_iters: int = 32,
                    reml: bool = True) -> Dict[str, torch.Tensor]:
    """Per-SNP REML delta for the designs [X0 | g_j] of a tile of rotated
    SNP rows Gt (m, n), with the JAX function's rule: the grid
    (emma_grid), then the bisection and the three candidates
    (emma_refine). One rule differs from the JAX function's: a refined
    point within the last bracket's width of its grid point is that grid
    point (the JAX function keeps the midpoint, up to 3.8e-7 away in log
    delta at the defaults, and compares two LLs equal up to rounding).
    logdet_XtX_all: (m,) ln|[X0 g_j]'[X0 g_j]|.
    Returns log_delta, delta, ll, ypy (the full model's GLS RSS at the
    SNP's delta) and beta (m, p)."""
    grid, k1, k2 = emma_grid(Gt, X0_rot, y_rot, phi, logdet_XtX_all,
                             ngrids, llim, ulim, reml)
    return emma_refine(Gt, X0_rot, y_rot, phi, logdet_XtX_all, grid, k1, k2,
                       refine_iters, reml)
