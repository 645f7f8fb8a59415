"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

  python3 chip_smoke.py                  # n = 10,240 samples x 262,144 SNPs
  python3 chip_smoke.py --snps 1048576   # the BASELINE #3 shape

Phases (each prints its own seconds):
  1 device check: fails without CUDA; prints the card's name and power
    limit as nvidia-smi reports them
  2 build the five CUDA kernels from mixmogam_tpu_torch/csrc, one nvcc
    each, all started together
  3 each kernel against its plain PyTorch version on the card, at the
    main path's shapes (n samples, one 16,384-row tile): K1 and K4 (over
    a row range that starts mid-tile) bit-equal for ploidy 1 and 2, and
    again at n = 2,042 (a row pitch of 511 bytes: the kernels' byte loads)
    over 3,001 rows; K2 (int8x2, int8x3), K3 and K5 (bf16, bf16x2, bf16x3,
    and bf16x3 on a genome with 2 % missing genotypes) within f rtol 1e-4 /
    atol 1e-4, beta atol 1e-5, identical masks, and bit-equal between a
    launch on the operand prepared once per rotated null and one that
    prepares it on the spot. K2 and K5 run, as on the main path, one launch
    over all rows in 256-row blocks: they are held and timed on the least
    launch that fills the card (one block an SM: 33,792 rows on an H100),
    and their time is also given per 16,384 rows. Each kernel's time stands
    beside its bound
    (the larger of its bytes over 3.35 TB/s and its operations over the
    card's data-sheet peak for their type) and, for K1 and K4, beside one
    torch._int_mm over the unpacked int8 rows; beside K2 and K5 stand their
    products alone through the library on unpacked rows (torch._int_mm a
    plane, a bf16 matmul a part), which the port never calls
  4 the main path at full width: draw the genome -> ResidentGenome on the
    card
    -> kinship_resident (K1) -> scale_k -> eigh on the card (float64)
    -> fit_null_model -> emmax_resident at 'exact' (K3), 'int8x3' (K2)
    and 'bf16x3' (K5); every kernel's launch count must be > 0, and each
    fast tier within max |dp| 1e-4 of exact. K3 is also held and timed at
    q = 11 and q = 128 Q0 columns (a grown stepwise design)
  5 end-to-end accuracy: exact-tier emmax on the card vs the port's
    float64 CPU path at n = 2,048 x 8,192 (max |dp| <= 1e-5, same masks)
  6 LOCO at full width, on phase 4's genome cut to --facade-snps rows in 5
    chromosomes in proportion to the Arabidopsis TAIR10 lengths (no
    boundary on a tile): the genome goes to a PLINK fileset (the port's
    write_plink) and the phenotype to a CSV, and api.run_gwas runs
    method='emmax_loco' from those files on the card (no device=); on its
    filtered rows emmax_loco runs directly at 'exact' and at 'bf16x3', each
    launching K4 exactly once per chromosome and K1 once; the facade's
    p-values equal the direct exact call's (max |dp| <= 1e-12) and its own
    ranked CSV; bf16x3 within max |dp| 1e-4 of exact; one chromosome's
    K_loco equal to scale_k of K1's gram over the other chromosomes' rows
    (max |d| <= 1e-12)
  7 the facade at full width, from the same files: api.run_gwas on the
    card with method='emmax' at 'exact', 'int8x3' and 'bf16x3'; each
    call's timings_s and route (in-core, or packed and resident) are
    printed; its p-values must equal (max |dp| <= 1e-12) those of the
    port's emmax called on the same filtered rows, y and K, the ranked CSV
    must parse back to the same p-values, and the kernels' launch counts
    must be the tabled ones (PERF.md section 6), as for phase 6's call.
    Then at n = 2,048 x 8,192 with 2 % missing calls: run_gwas with the IBS
    and with the VanRaden kinship (float32 matmuls on the card) against the
    same call on the float64 CPU path: max |dK| <= 1e-5, max |dp| <= 1e-4;
    on that genome, VanRaden's K_loco of the middle chromosome in float64 on
    the card equals the direct kinship over the other rows (max |d| <=
    1e-12). Then VanRaden's K with delta at its lower bound (n = 256 x 3,000, seed
    3, no noise; a zero eigenvalue along the intercept): run_gwas on the
    card at 'exact' against the float64 CPU path, identical masks and
    max |dp| <= 1e-4, with int8x3 and bf16x3 printed beside it. Then, from
    phase 6's PLINK fileset: run_gwas method='emmax_stepwise' with its
    timings_s (K3 must launch), and emmax_loco with the VanRaden kinship on
    the card (float32 kinship matmuls, no K1 or K4: the float route; K3)
  8 stepwise MLMM on phase 4's resident genome, K and eigh (n x M, binary):
    emmax_step_wise with the stored rotation (10 steps: G @ U' once, then
    one K3 launch over all rows a step) and over the rotation budget (3
    steps: unpack + fp32 GEMM + K3 a tile, every step); each route's wall,
    the rotation, the mean per-step scan and K3's launches are printed; the
    two routes choose the same cofactors and their forward min_p agree to
    rtol 1e-4. Then the card (float32) against the float64 CPU path at
    n = 1,024 x 8,192: the same cofactor path and selected models, step 0's
    scan within max |dp| 1e-5 with identical masks

The line before the last is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}. Any
failed phase exits non-zero before either is printed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# NVIDIA's data sheet for the H100 SXM, dense: operations a second by
# operand type, and device-memory bytes a second
_PEAK = {"int8": 1.979e15, "bf16": 9.89e14, "fp32": 6.7e13}
_HBM_BYTES_S = 3.35e12


def _bound(ops: float, kind: str, *tensors) -> dict:
    """The least time the card could take: every tensor given (inputs and
    the output) crosses device memory once, `ops` operations run at the
    peak rate of `kind`; the larger of the two, in ms."""
    by = sum(t.numel() * t.element_size() for t in tensors)
    t_b, t_o = by / _HBM_BYTES_S * 1e3, ops / _PEAK[kind] * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def _gram_ops(n: int, rows: int, ploidy: int) -> float:
    """K1 / K4: the upper triangle (diagonal included) of the 0/1 planes'
    gram, ploidy * rows deep, two operations a multiply-add."""
    return 2.0 * (n * (n + 1) // 2) * ploidy * rows


def _int_mm_ms(Zt, what: str):
    """Time of one torch._int_mm(Z^T, Z) over unpacked int8 rows given as
    the contiguous (n, rows) Z^T (rows padded with zeros to a multiple of
    8, which the call requires); None, with the reason printed, if this
    PyTorch lacks the call or refuses the shape."""
    import torch

    k = Zt.shape[1]
    if k % 8:
        Zt = torch.nn.functional.pad(Zt, (0, -k % 8))
    return _library_ms(lambda: torch._int_mm(Zt, Zt.t()),
                       f"{what}: torch._int_mm")


def _library_ms(fn, what: str):
    """Time of the library call fn(), which the port never makes; None,
    with the reason printed, if this PyTorch lacks the call or refuses the
    shape. A fault that an earlier kernel left on the card raises before
    the attempt, and one in the timed launches after it: neither is taken
    for a refusal."""
    import torch

    torch.cuda.synchronize()
    try:
        fn()
    except (AttributeError, RuntimeError) as exc:
        print(f"{what} not timed: {str(exc)[:200]}", flush=True)
        return None
    return _cuda_ms(fn)


def _check_stats(name, got, ref):
    """K2/K3 against their plain versions: the JAX kernel tests'
    tolerances (tests/test_kernels.py: f rtol 1e-4 / atol 1e-4, beta
    atol 1e-5) and identical masks. Returns max |df|."""
    import torch

    g, r = got.double().cpu(), ref.double().cpu()
    if not torch.equal(g[3] > 0.5, r[3] > 0.5):
        raise AssertionError(f"{name}: masks differ in "
                             f"{int(((g[3] > 0.5) != (r[3] > 0.5)).sum())}"
                             " rows")
    df = (g[0] - r[0]).abs()
    if not bool((df <= 1e-4 + 1e-4 * r[0].abs()).all()):
        raise AssertionError(f"{name}: f differs by up to {df.max():.3e}")
    db = (g[1] - r[1]).abs().max().item()
    if db > 1e-5:
        raise AssertionError(f"{name}: beta differs by up to {db:.3e}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    return df.max().item()


def _read_ranked_csv(path):
    """{(chromosome, position): p} from a ranked p-value CSV."""
    with open(path) as f:
        head = f.readline().strip().split(",")
        if head[:3] != ["chromosomes", "positions", "scores"]:
            raise AssertionError(f"{path}: header {head}")
        return {(int(c), int(p)): float(v) for c, p, v in (
            line.split(",")[:3] for line in f)}


def _draw_genotypes(n: int, m: int, ploidy: int = 1,
                    missing_rate: float = 0.0, seed: int = 0):
    """(m, n) int8 host genotypes (-1 = missing) of data/simulate.py's
    model (Balding-Nichols: 3 populations, Fst 0.1, ancestral frequencies
    uniform on 0.05-0.5). The per-SNP frequencies come from numpy; the
    (m, n) uniform draws are made on the card, which numpy makes in half a
    minute for 262,144 x 10,240 on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, size=m)
    freqs = torch.as_tensor(
        rng.beta(p * 9.0, (1.0 - p) * 9.0, size=(3, m)).astype(np.float32),
        device="cuda")
    pop = torch.as_tensor(rng.integers(0, 3, size=n), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = np.empty((m, n), dtype=np.int8)
    for s in range(0, m, 16_384):
        f = freqs[:, s:s + 16_384][pop].T               # (rows, n)
        acc = torch.zeros(f.shape, dtype=torch.int8, device="cuda")
        for _ in range(ploidy):
            acc += torch.rand(f.shape, generator=g, device="cuda") < f
        if missing_rate > 0:
            acc[torch.rand(f.shape, generator=g, device="cuda")
                < missing_rate] = -1
        G[s:s + 16_384] = acc.cpu().numpy()
    return G


def _check_no_jax() -> None:
    """The port runs without JAX and without the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "mixmogam_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--snps", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--facade-snps", type=int, default=32_768,
                    help="SNP rows of phases 6 and 7 (LOCO and the facade): "
                         "the host data layer decodes, gathers and filters "
                         "the int8 matrix with numpy, seconds for each "
                         "32,768 rows")
    args = ap.parse_args(argv)

    # ---- 1. device check ------------------------------------------------
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    import numpy as np
    # the p-values' scipy.stats takes seconds to import: load it here, not
    # inside the first timed emmax call
    import scipy.stats  # noqa: F401

    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.plink import write_plink
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco, loco_kinships
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    emmax_scan_packed,
                                                    kinship_resident,
                                                    row_means_packed,
                                                    scale_k)
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.eigen import eigen_k
    from mixmogam_tpu_torch.ops.hopper_kinship import (
        ibs_gram_packed, ibs_gram_packed_plain, ibs_gram_tri_packed,
        ibs_gram_tri_packed_plain)
    from mixmogam_tpu_torch.ops.hopper_scan import (
        rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain,
        rotate_scan_int8_packed, rotate_scan_int8_packed_plain, scan_operand,
        scan_stats, scan_stats_plain)
    from mixmogam_tpu_torch.ops.reml import NullModel, fit_null_model
    from mixmogam_tpu_torch.ops.scan import build_rotated_null
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    _check_no_jax()
    dev = torch.device("cuda")
    _phase("1 device check", t0)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all(("ibs_gram", "ibs_gram_tri", "rotate_scan_int8",
                              "rotate_scan_bf16", "scan_stats"))
    for name, sec in built.items():
        print(f"built {name}.cu in {sec:.3f} s", flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Performance Loss" in line):
                print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
    _phase("2 build", t0)

    # ---- 3. kernels vs plain versions on the card -------------------------
    t0 = time.perf_counter()
    # the kernels see the main path's widths: all n samples, and one
    # resident tile of SNP rows
    n, M = args.samples, args.snps
    rows = min(16_384, M)
    report = {}
    for ploidy in (1, 2):
        Gc = _draw_genotypes(n, rows, ploidy=ploidy,
                             seed=args.seed + 10 + ploidy)
        rgc = ResidentGenome.from_source(Gc, device=dev, ploidy=ploidy)
        S = ibs_gram_packed(rgc.packed, n, rows, ploidy)
        S_ref = ibs_gram_packed_plain(rgc.packed, n, rows, ploidy)
        if not torch.equal(S, S_ref):
            raise AssertionError(
                f"K1 ploidy {ploidy}: not bit-equal ("
                f"{int((S != S_ref).sum())} entries differ)")
        ms = _cuda_ms(lambda: ibs_gram_packed(rgc.packed, n, rows, ploidy))
        pms = _cuda_ms(lambda: ibs_gram_packed_plain(rgc.packed, n, rows,
                                                     ploidy))
        print(f"K1 ibs_gram_packed ploidy {ploidy} n={n} rows={rows}: "
              f"bit-equal, kernel {ms:.3f} ms, plain {pms:.3f} ms",
              flush=True)
        bnd = _bound(_gram_ops(n, rows, ploidy), "int8", rgc.packed, S)
        print(f"   bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
              flush=True)
        if ploidy == 1:
            Zt = torch.as_tensor(Gc, device=dev).T.contiguous()
            lms = _int_mm_ms(Zt, "K1")
            print(f"   torch._int_mm(Z^T, Z), full square, n={n} "
                  f"rows={rows}: {lms} ms", flush=True)
            report["ibs_gram_packed"] = dict(max_abs_err=0.0, ms=ms,
                                             plain_ms=pms, library_ms=lms,
                                             **bnd)
        # K4 over a row range that starts and ends inside a tile; it must
        # equal its plain version and K1 over the same rows
        s3, e3 = rows // 5 + 3, rows - 123
        S4 = ibs_gram_tri_packed(rgc.packed, n, s3, e3, ploidy)
        S4_ref = ibs_gram_tri_packed_plain(rgc.packed, n, s3, e3, ploidy)
        sub = rgc.slice_rows(s3, e3)
        S1_sub = ibs_gram_packed(sub.packed, n, sub.M, ploidy)
        if not (torch.equal(S4, S4_ref) and torch.equal(S4, S1_sub)):
            raise AssertionError(
                f"K4 ploidy {ploidy} rows [{s3}, {e3}): not bit-equal ("
                f"{int((S4 != S4_ref).sum())} entries differ from the "
                f"plain version, {int((S4 != S1_sub).sum())} from K1)")
        ms = _cuda_ms(lambda: ibs_gram_tri_packed(rgc.packed, n, s3, e3,
                                                  ploidy))
        pms = _cuda_ms(lambda: ibs_gram_tri_packed_plain(rgc.packed, n, s3,
                                                         e3, ploidy))
        print(f"K4 ibs_gram_tri_packed ploidy {ploidy} n={n} rows "
              f"[{s3}, {e3}): bit-equal (and to K1 on those rows), kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms", flush=True)
        bnd = _bound(_gram_ops(n, e3 - s3, ploidy), "int8",
                     rgc.packed[s3:e3], S4)
        print(f"   bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
              flush=True)
        if ploidy == 1:
            lms = _int_mm_ms(Zt[:, s3:e3].contiguous(), "K4")
            print(f"   torch._int_mm(Z^T, Z), full square, rows "
                  f"[{s3}, {e3}): {lms} ms", flush=True)
            report["ibs_gram_tri_packed"] = dict(max_abs_err=0.0, ms=ms,
                                                 plain_ms=pms,
                                                 library_ms=lms, **bnd)
            G1, rg1 = Gc, rgc
            del Zt
        del sub, S1_sub, S4, S4_ref
    # K1 and K4 again where the row pitch is no multiple of 4 bytes (the
    # kernels' byte loads), n ends inside a tile and the rows inside a stage
    nr, mr = 2_042, 3_001
    for ploidy in (1, 2):
        Gr = _draw_genotypes(nr, mr, ploidy=ploidy,
                             seed=args.seed + 30 + ploidy)
        rgr = ResidentGenome.from_source(Gr, ploidy=ploidy)
        sr, er = mr // 7 + 1, mr - 70
        Sr = ibs_gram_packed(rgr.packed, nr, mr, ploidy)
        S4r = ibs_gram_tri_packed(rgr.packed, nr, sr, er, ploidy)
        if not (torch.equal(Sr, ibs_gram_packed_plain(rgr.packed, nr, mr,
                                                      ploidy))
                and torch.equal(S4r, ibs_gram_tri_packed_plain(
                    rgr.packed, nr, sr, er, ploidy))
                and torch.equal(S4r, ibs_gram_packed(
                    rgr.packed[sr:er], nr, er - sr, ploidy))
                and torch.equal(Sr, ibs_gram_tri_packed(rgr.packed, nr, 0,
                                                        mr, ploidy))):
            raise AssertionError(f"K1/K4 ploidy {ploidy} n={nr} rows={mr}: "
                                 "not bit-equal")
        ms = _cuda_ms(lambda: ibs_gram_packed(rgr.packed, nr, mr, ploidy))
        msw = _cuda_ms(lambda: ibs_gram_packed(
            rgr.packed[:, :508].contiguous(), 2_032, mr, ploidy))
        print(f"K1/K4 ploidy {ploidy} n={nr} (pitch {rgr.packed.shape[1]}) "
              f"rows={mr}, K4 rows [{sr}, {er}): bit-equal to plain and to "
              f"each other; K1 {ms:.3f} ms with byte loads, {msw:.3f} ms "
              f"with 32-bit loads at n=2032", flush=True)
    del Gr, rgr, Sr, S4r
    # a rotated null at the main path's width: random orthonormal U
    g = torch.Generator(device=dev).manual_seed(args.seed)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev))
    phi = torch.sort(torch.rand(n, generator=g, device=dev) * 2.0,
                     descending=True).values
    yv = torch.randn(n, generator=g, device=dev)
    one = torch.ones((), device=dev)
    null = NullModel(phi=phi, U=U, delta=one, log_delta=0 * one, ll=one,
                     sigma_g2=one, sigma_e2=one, pseudo_heritability=one / 2,
                     y=yv, X0=torch.ones((n, 1), device=dev))
    # K2 and K5 take all rows in one launch of 256-row blocks, on the main
    # path several to an SM: the least launch of that kind, one block an SM
    srows = min(args.snps, 256 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    Gs = _draw_genotypes(n, srows, seed=args.seed + 40)
    packed_s = ResidentGenome.from_source(Gs, tile=256,
                                          device=dev).packed[:srows]
    # the unpacked rows for the library's products: the share of cuBLAS's
    # rate that the fused kernels reach (the port never calls these)
    G8 = torch.as_tensor(Gs, device=dev)
    Gb = G8.to(torch.bfloat16)
    # K2 at the fast tier and at the fp32-grade one (the report's row); the
    # operand is prepared once per rotated null, as on the main path, so
    # the time is the kernel's alone
    for tier in ("int8x2", "int8x3"):
        rot8 = build_rotated_null(null, rotate_dtype=tier)
        a8 = (packed_s, n, rot8.planes, rot8.w_scale, rot8.y_res, rot8.Q0,
              rot8.rss0, rot8.dof)
        ts = time.perf_counter()
        op8 = scan_operand(rot8)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - ts
        got = rotate_scan_int8_packed(*a8, operand=op8)
        if not torch.equal(got, rotate_scan_int8_packed(*a8)):
            raise AssertionError(f"K2 {tier}: a second launch (operand "
                                 "prepared on the spot) is not bit-equal")
        err = _check_stats(f"K2 {tier}", got,
                           rotate_scan_int8_packed_plain(*a8))
        ms = _cuda_ms(lambda: rotate_scan_int8_packed(*a8, operand=op8))
        pms = _cuda_ms(lambda: rotate_scan_int8_packed_plain(*a8))
        # a product of rows x n x n multiply-adds for each plane; the
        # epilogue's few operations a row are left out
        nplanes = rot8.planes.shape[0]
        bnd = _bound(2.0 * nplanes * srows * n * n, "int8",
                     *(t for t in a8 if isinstance(t, torch.Tensor)),
                     torch.empty((4, srows)))
        planes_t = [p_.t().contiguous().t() for p_ in rot8.planes]
        lms = _library_ms(lambda: [torch._int_mm(G8, p_) for p_ in planes_t],
                     f"{nplanes} x torch._int_mm(G_s8, P_p)")
        print(f"   products alone through the library, unpacked rows: "
              f"{nplanes} x torch._int_mm(G_s8, P_p) {lms} ms; operand "
              f"prepared once in {prep_s * 1e3:.1f} ms", flush=True)
        print(f"K2 rotate_scan_int8_packed {tier} n={n} rows={srows}: "
              f"max|df| {err:.3e}, kernel {ms:.3f} ms "
              f"({ms * 16_384 / srows:.3f} ms per 16,384 rows), plain "
              f"{pms:.3f} ms, bound {bnd['bound_ms']:.3f} ms by "
              f"{bnd['bound_by']}", flush=True)
        if tier == "int8x3":
            report["rotate_scan_int8_packed"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, **bnd)
        del planes_t, op8, rot8, a8
    # K5 at each bf16 tier, then bf16x3 on a genome with 2 % missing
    # genotypes (per-row means, rounded to bf16 in the kernel)
    Gm = _draw_genotypes(n, srows, missing_rate=0.02, seed=args.seed + 20)
    rgm = ResidentGenome.from_source(Gm, tile=256, device=dev)
    mu = row_means_packed(rgm.packed, n, 16_384, torch.float32)[:srows]
    errs = []
    for tier in ("bf16", "bf16x2", "bf16x3", "bf16x3 missing"):
        rotb = build_rotated_null(null, tier.split()[0])
        a5 = (packed_s, n, rotb.parts, rotb.y_res, rotb.Q0, rotb.rss0,
              rotb.dof, None)
        if tier.endswith("missing"):
            a5 = (rgm.packed[:srows],) + a5[1:-1] + (mu,)
        ts = time.perf_counter()
        op5 = scan_operand(rotb)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - ts
        got = rotate_scan_bf16_packed(*a5, operand=op5)
        if not torch.equal(got, rotate_scan_bf16_packed(*a5)):
            raise AssertionError(f"K5 {tier}: a second launch (operand "
                                 "prepared on the spot) is not bit-equal")
        ref = rotate_scan_bf16_packed_plain(*a5)
        errs.append(_check_stats(f"K5 {tier}", got, ref))
        dbeta = float((got[1] - ref[1]).abs().max())
        ms = _cuda_ms(lambda: rotate_scan_bf16_packed(*a5, operand=op5))
        pms = _cuda_ms(lambda: rotate_scan_bf16_packed_plain(*a5))
        # one product of rows x n x n multiply-adds for each bf16 part
        nparts = rotb.parts.shape[0]
        bnd = _bound(2.0 * nparts * srows * n * n, "bf16",
                     *(t for t in a5 if isinstance(t, torch.Tensor)),
                     torch.empty((4, srows)))
        if not tier.endswith("missing"):
            lms = _library_ms(lambda: [Gb @ p_ for p_ in rotb.parts],
                         f"{nparts} x (G_bf16 @ P_p)")
            print(f"   products alone through the library, unpacked rows: "
                  f"{nparts} x (G_bf16 @ P_p) {lms} ms; operand prepared "
                  f"once in {prep_s * 1e3:.1f} ms", flush=True)
        print(f"K5 rotate_scan_bf16_packed {tier} n={n} rows={srows}: "
              f"max|df| {errs[-1]:.3e}, max|dbeta| {dbeta:.3e}, kernel "
              f"{ms:.3f} ms ({ms * 16_384 / srows:.3f} ms per 16,384 rows), "
              f"plain {pms:.3f} ms, bound {bnd['bound_ms']:.3f} ms by "
              f"{bnd['bound_by']}", flush=True)
        if tier == "bf16x3":
            report["rotate_scan_bf16_packed"] = dict(ms=ms, plain_ms=pms,
                                                     library_ms=None, **bnd)
        del op5
    report["rotate_scan_bf16_packed"]["max_abs_err"] = max(errs)
    del G8, Gb, got, ref
    del a5, rotb, rgm, Gm, mu, Gs, packed_s
    rot = build_rotated_null(null)
    Xr = torch.as_tensor(G1, device=dev).float() @ rot.U
    a3 = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    err = _check_stats("K3 scan_stats", scan_stats(*a3),
                       scan_stats_plain(*a3))
    ms = _cuda_ms(lambda: scan_stats(*a3))
    pms = _cuda_ms(lambda: scan_stats_plain(*a3))
    # a row's dot products with y_res and the q columns of Q0, and its
    # sum of squares: 2 n (2 + q) float32 operations
    bnd = _bound(2.0 * rows * n * (2 + rot.Q0.shape[1]), "fp32",
                 *(t for t in a3 if isinstance(t, torch.Tensor)),
                 torch.empty((4, rows)))
    report["scan_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                library_ms=None, **bnd)
    print(f"K3 scan_stats n={n} rows={rows}: max|df| {err:.3e}, kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bnd['bound_ms']:.3f} ms "
          f"by {bnd['bound_by']}", flush=True)
    # K3 at the widths of a grown stepwise design: q = 11 on the register
    # path, q = 128 (the most it takes) on the wide one
    for q in (11, 128):
        Qq, _ = torch.linalg.qr(torch.randn(n, q, generator=g, device=dev))
        yq = rot.y_res - Qq @ (Qq.T @ rot.y_res)
        aq = (Xr, rot.sd, yq, Qq, float(yq @ yq), float(n - q - 1))
        got = scan_stats(*aq)
        if not torch.equal(got, scan_stats(*aq)):
            raise AssertionError(f"K3 q={q}: two launches differ")
        errq = _check_stats(f"K3 scan_stats q={q}", got,
                            scan_stats_plain(*aq))
        msq = _cuda_ms(lambda: scan_stats(*aq))
        bq = _bound(2.0 * rows * n * (2 + q), "fp32", Xr, rot.sd, yq, Qq,
                    torch.empty((4, rows)))
        print(f"K3 scan_stats q={q} n={n} rows={rows}: max|df| {errq:.3e}, "
              f"kernel {msq:.3f} ms, bound {bq['bound_ms']:.3f} ms by "
              f"{bq['bound_by']}", flush=True)
    try:
        scan_stats(Xr, rot.sd, rot.y_res, torch.zeros((n, 129), device=dev),
                   rot.rss0, rot.dof)
    except ValueError:
        pass
    else:
        raise AssertionError("K3 took 129 columns of Q0")
    del Xr, a3, rot, null, U, rg1, rgc, G1, Gc, S, S_ref, got
    torch.cuda.empty_cache()
    _phase("3 kernels vs plain", t0)

    # ---- 4. main path at full width --------------------------------------
    t0 = time.perf_counter()
    ts = time.perf_counter()
    G = _draw_genotypes(n, M, seed=args.seed)
    y, causal = simulate_phenotype(G[:16_384], h2=0.6, n_causal=10,
                                   causal_effect=1.0, seed=args.seed)
    print(f"draw {M} x {n} genotypes (uniform draws on the card) and the "
          f"phenotype: {time.perf_counter() - ts:.3f} s", flush=True)
    kernels = (ibs_gram_packed, ibs_gram_tri_packed, rotate_scan_int8_packed,
               rotate_scan_bf16_packed, scan_stats)
    for k in kernels:
        k.launches = 0
    ts = time.perf_counter()
    rg = ResidentGenome.from_source(G)          # no device=: the card
    torch.cuda.synchronize()
    print(f"pack + upload: {time.perf_counter() - ts:.3f} s "
          f"({rg.nbytes_packed / 1e6:.1f} MB packed)", flush=True)
    ts = time.perf_counter()
    K = scale_k(kinship_resident(rg))
    print(f"kinship_resident (K1) + scale_k: "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    ts = time.perf_counter()
    phi, U = eigen_k(torch.as_tensor(K, device=dev), host=False)
    torch.cuda.synchronize()
    print(f"eigh on the card (float64, n={n}): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    fits = []
    for _ in range(2):      # the first pays the process's first REML
        ts = time.perf_counter()
        null = fit_null_model(y, np.ones((n, 1)), eig_k=(phi, U), device=dev,
                              dtype=torch.float32)
        fits.append(time.perf_counter() - ts)
    print(f"fit_null_model: {fits[0]:.3f} s, again {fits[1]:.3f} s "
          f"(h2 {float(null.pseudo_heritability):.4f})", flush=True)
    res = {}
    for tier in ("exact", "int8x3", "bf16x3"):
        rot = build_rotated_null(null, None if tier == "exact" else tier)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        emmax_scan_packed(rg.packed, rot, n, rg.tile)
        torch.cuda.synchronize()
        dt_scan = time.perf_counter() - ts
        ts = time.perf_counter()
        res[tier] = emmax_resident(rg, y, eig_k=(phi, U), precision=tier)
        dt_all = time.perf_counter() - ts
        print(f"scan {tier}: {dt_scan:.3f} s = {M / dt_scan:,.0f} "
              f"SNP-tests/s; emmax_resident {tier} (null fit + scan + "
              f"p-values): {dt_all:.3f} s", flush=True)
        del rot
    launches = {k.__name__: k.launches for k in kernels}
    for name, cnt in launches.items():
        if cnt <= 0 and name != "ibs_gram_tri_packed":
            raise AssertionError(f"main path never launched {name}")
    # K1 alone over the whole genome (after the counts were read: this
    # launch is a timing, not part of the path)
    k1_ms = _cuda_ms(lambda: ibs_gram_packed(rg.packed, n, M, rg.ploidy),
                     reps=2)
    bnd = _bound(_gram_ops(n, rg.packed.shape[0], rg.ploidy), "int8",
                 rg.packed, torch.empty((n, n), dtype=torch.int32))
    print(f"K1 over the whole genome (n={n}, M={M}): {k1_ms:.3f} ms a "
          f"launch, bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
          flush=True)
    ex = res["exact"]
    for tier, r in res.items():
        ps = r["ps"]
        if ps.shape != (M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"{tier}: p-values malformed")
        if r["dof"] != n - 2:
            raise AssertionError(f"{tier}: dof {r['dof']} != {n - 2}")
    dps = {t: float(np.abs(res[t]["ps"] - ex["ps"]).max())
           for t in ("int8x3", "bf16x3")}
    top = set(np.argsort(ex["ps"])[:20].tolist())
    hits = len(top & set(causal.tolist()))
    print(f"int8x3 vs exact: max|dp| {dps['int8x3']:.3e}; bf16x3 vs exact: "
          f"max|dp| {dps['bf16x3']:.3e}; causal SNPs among the exact top "
          f"20: {hits} of {len(causal)}", flush=True)
    if max(dps.values()) > 1e-4 or hits < 3:
        raise AssertionError("main path results off")
    # G and y stay for phase 6's files; the resident genome and eigh(K)
    # for phase 8
    main = dict(rg=rg, eig=(phi, U), y=y)
    del K, null, res, ex
    torch.cuda.empty_cache()
    _phase("4 main path", t0)

    # ---- 5. end-to-end accuracy vs the float64 CPU path -------------------
    t0 = time.perf_counter()
    na, Ma = 2_048, 8_192
    Ga, _, _ = simulate_genotypes(na, Ma, ploidy=1, seed=args.seed + 1)
    ya, _ = simulate_phenotype(Ga, h2=0.5, n_causal=5, seed=args.seed + 1)
    # no device= means the card: pack, gram (K1) and scan there; the
    # float64 reference asks for the CPU
    rga = ResidentGenome.from_source(Ga)
    if rga.device.type != "cuda":
        raise AssertionError(f"default device is {rga.device}, not the card")
    k1_before = ibs_gram_packed.launches
    Ka = scale_k(kinship_resident(rga))
    if ibs_gram_packed.launches != k1_before + 1:
        raise AssertionError("phase 5's kinship did not launch K1")
    eig = eigen_k(Ka)
    a = emmax(Ga, ya, eig_k=eig)
    b = emmax(Ga, ya, eig_k=eig, device="cpu")
    dpa = float(np.abs(a["ps"] - b["ps"]).max())
    print(f"emmax exact, card f32 vs CPU f64 (n={na}, M={Ma}): "
          f"max|dp| {dpa:.3e}", flush=True)
    if dpa > 1e-5 or not np.array_equal(a["mask"], b["mask"]):
        raise AssertionError("card vs CPU p-values disagree")
    _phase("5 accuracy vs CPU float64", t0)

    # ---- 6. LOCO at full width: from files through the facade, and direct -
    t0 = time.perf_counter()
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    # run_gwas's own phase lines (utils/profiling.py sets its logger up
    # when first imported): each call's timings are printed below
    import mixmogam_tpu_torch.utils.profiling  # noqa: F401
    logging.getLogger("mixmogam_tpu_torch").setLevel(logging.WARNING)
    logging.getLogger("mixmogam_tpu_torch.loco").setLevel(logging.INFO)
    Mf = min(args.facade_snps, M)
    acc = [f"acc{i}" for i in range(n)]

    def facade(label, files, direct, expect, **kw):
        """One run_gwas call from files on the card, held to `direct` (the
        port's scan entry point on the call's own filtered rows, y and K)
        and to the launch counts `expect(result)`."""
        for k in kernels:
            k.launches = 0
        ResidentGenome.packs = 0
        out = api.run_gwas(files[0], files[1], data_format="plink",
                           plots=False, out_prefix=files[2], **kw)
        run = {k.__name__: k.launches for k in kernels}
        packs = ResidentGenome.packs
        for name, cnt in run.items():
            launches[name] += cnt
        g2, ps = out["genotype"], out["scan"]["ps"]
        with open(out["files"]["summary"]) as f:
            timings = json.load(f)["timings_s"]
        print(f"run_gwas {label} on {torch.cuda.get_device_name(0)}: "
              f"n={g2.num_samples} M={g2.num_snps} ploidy={g2.ploidy} "
              f"timings_s {json.dumps(timings)}", flush=True)
        route = ("in-core (the genome packed once, for the kinship)"
                 if packs == 1 and kw.get("method") != "emmax_loco"
                 else f"resident (the genome packed {packs} time(s))")
        print(f"   route: {route}; launches {run}", flush=True)
        if packs == 2:
            ts = time.perf_counter()
            ResidentGenome.from_source(g2)
            torch.cuda.synchronize()
            print(f"   one packing of these rows (pack + upload + the packed "
                  f"rows' read-back), timed alone: "
                  f"{time.perf_counter() - ts:.3f} s", flush=True)
        if ps.shape != (g2.num_snps,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"run_gwas {label}: p-values malformed")
        want = expect(g2)
        if run != want:
            raise AssertionError(f"run_gwas {label}: launches {run}, "
                                 f"tabled {want}")
        ts = time.perf_counter()
        ref = direct(g2, out["y"])
        dp = float(np.abs(ps - ref["ps"]).max())
        on_disk = _read_ranked_csv(out["files"]["pvals"])
        back = np.array([on_disk[(int(c), int(p_))] for c, p_ in
                         zip(g2.chromosomes, g2.positions)])
        dcsv = float(np.abs(back - ps).max())
        print(f"   vs the direct call on the same rows, y and K: max|dp| "
              f"{dp:.3e}; CSV read back: max|dp| {dcsv:.3e} over "
              f"{len(on_disk)} rows ({time.perf_counter() - ts:.3f} s)",
              flush=True)
        if dp > 1e-12 or dcsv != 0.0 or len(on_disk) != g2.num_snps:
            raise AssertionError(f"run_gwas {label} disagrees with the "
                                 "direct path or with its own CSV")
        return out

    def loco_ranges(g2):
        c = g2.chromosomes
        cuts = np.flatnonzero(np.diff(c)) + 1
        return list(zip(np.r_[0, cuts].tolist(), np.r_[cuts, len(c)].tolist()))

    def tiles(g2, ranges=None):
        ranges = ranges or [(0, g2.num_snps)]
        return sum(-(-(e - s) // 16_384) for s, e in ranges)

    def counts(**kw):
        return {**{k.__name__: 0 for k in kernels}, **kw}

    loco = {}

    def loco_direct(tier, scan_kernel):
        """emmax_loco on the facade call's own rows, packed once and kept
        on the card: the direct LOCO path, its launches counted."""
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        r = emmax_loco(loco["rg"], loco["y"], chromosomes=loco["chrom"],
                       precision=tier)
        torch.cuda.synchronize()
        run = {k.__name__: k.launches for k in kernels}
        print(f"emmax_loco {tier} (M={loco['rg'].M}): "
              f"{time.perf_counter() - ts:.3f} s; launches {run}", flush=True)
        if (run["ibs_gram_tri_packed"] != 5 or run["ibs_gram_packed"] != 1
                or run[scan_kernel.__name__] <= 0):
            raise AssertionError(f"LOCO {tier}: launches {run}")
        for name, cnt in run.items():
            launches[name] += cnt
        ps = r["ps"]
        if ps.shape != (loco["rg"].M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"LOCO {tier}: p-values malformed")
        return r

    def loco_exact_on(g2, y2):
        loco.update(rg=ResidentGenome.from_source(g2), y=y2,
                    chrom=np.asarray(g2.chromosomes))
        loco["exact"] = loco_direct("exact", scan_stats)
        return loco["exact"]

    with tempfile.TemporaryDirectory() as tmp:
        ts = time.perf_counter()
        # the first Mf rows, in 5 chromosomes of TAIR10's proportions
        tair10_mb = np.array([30.43, 19.70, 23.46, 18.59, 26.98])
        ends = np.round(np.cumsum(tair10_mb) / tair10_mb.sum()
                        * Mf).astype(int)
        gd = GenotypeData(G[:Mf], np.repeat(np.arange(1, 6),
                                            np.diff(np.r_[0, ends])),
                          np.arange(1, Mf + 1) * 100, acc, ploidy=1)
        prefix = os.path.join(tmp, "cohort")
        write_plink(prefix, gd)
        pheno = os.path.join(tmp, "pheno.csv")
        PhenotypeData.from_arrays(1, "trait", acc, y).write_to_file(pheno)
        bed_mb = os.path.getsize(prefix + ".bed") / 1e6
        print(f"wrote {prefix}.bed/.bim/.fam ({bed_mb:.1f} MB) and the "
              f"phenotype CSV: {time.perf_counter() - ts:.3f} s (M={Mf})",
              flush=True)
        del gd, G
        files = (prefix + ".bed", pheno)
        # the facade's LOCO call, held to the direct exact call on its rows;
        # then the bf16x3 tier on the same rows against that exact call
        facade("emmax_loco exact", files + (os.path.join(tmp, "loco"),),
               loco_exact_on,
               lambda g2: counts(ibs_gram_packed=1,
                                 ibs_gram_tri_packed=len(loco_ranges(g2)),
                                 scan_stats=tiles(g2, loco_ranges(g2))),
               method="emmax_loco")
        rg, chrom = loco["rg"], loco["chrom"]
        cuts = np.flatnonzero(np.diff(chrom)) + 1
        print(f"LOCO chromosome starts {cuts.tolist()} of {rg.M} rows (tile "
              f"{rg.tile})", flush=True)
        if len(cuts) != 4 or (cuts % rg.tile == 0).any():
            raise AssertionError(f"LOCO needs 5 chromosomes with no boundary "
                                 f"on a tile: {cuts.tolist()}")
        loco["bf16x3"] = loco_direct("bf16x3", rotate_scan_bf16_packed)
        dpl = float(np.abs(loco["bf16x3"]["ps"] - loco["exact"]["ps"]).max())
        deltas = [round(v["delta"], 6)
                  for v in loco["exact"]["loco"].values()]
        print(f"LOCO bf16x3 vs exact: max|dp| {dpl:.3e}; deltas {deltas}",
              flush=True)
        if dpl > 1e-4:
            raise AssertionError("LOCO bf16x3 disagrees with exact")
        # K_loco of the middle chromosome against the direct gram over the
        # other rows; its neighbours are merged to a side each, so three
        # kinships are built for the one that is read
        ts = time.perf_counter()
        s_c, e_c = int(cuts[1]), int(cuts[2])
        sides = np.repeat([0, 1, 2], [s_c, e_c - s_c, rg.M - e_c])
        K_c = loco_kinships(rg, sides)[1]
        rest = torch.cat([rg.packed[:s_c], rg.packed[e_c:rg.M]])
        rg_rest = ResidentGenome(rest, rest.shape[0], n, rg.ploidy, rg.tile,
                                 False)
        dk = float(np.abs(K_c - scale_k(kinship_resident(rg_rest))).max())
        print(f"K_loco identity, chromosome 3: max|d| {dk:.3e} "
              f"({time.perf_counter() - ts:.3f} s)", flush=True)
        if dk > 1e-12:
            raise AssertionError("K_loco differs from the direct gram")
        del rg, rg_rest, rest, K_c
        loco.clear()
        torch.cuda.empty_cache()
        _check_no_jax()
        _phase("6 LOCO", t0)

        # ---- 7. the facade: files -> run_gwas -> ranked CSV ---------------
        t0 = time.perf_counter()
        logging.getLogger("mixmogam_tpu_torch.loco").setLevel(logging.WARNING)

        def direct_emmax(precision):
            def fn(g2, y2):
                K2 = cached_kinship(g2, "ibs")
                return emmax(g2, y2, K=K2, precision=precision)
            return fn

        facade("emmax exact", files + (os.path.join(tmp, "exact"),),
               direct_emmax(None),
               lambda g2: counts(ibs_gram_packed=1, scan_stats=tiles(g2)))
        facade("emmax int8x3", files + (os.path.join(tmp, "int8x3"),),
               direct_emmax("int8x3"),
               lambda g2: counts(ibs_gram_packed=1, rotate_scan_int8_packed=1),
               precision="int8x3")
        facade("emmax bf16x3", files + (os.path.join(tmp, "bf16x3"),),
               direct_emmax("bf16x3"),
               lambda g2: counts(ibs_gram_packed=1, rotate_scan_bf16_packed=1),
               precision="bf16x3")

        # missing calls and the VanRaden kinship: float32 matmuls on the
        # card against the float64 CPU path, from the same files
        ts = time.perf_counter()
        nm, Mm = 2_048, 8_192
        Gm, chm, pom = simulate_genotypes(nm, Mm, ploidy=2, missing_rate=0.02,
                                          seed=args.seed + 50)
        ym, _ = simulate_phenotype(Gm, h2=0.5, n_causal=5, seed=args.seed + 50)
        accm = [f"m{i}" for i in range(nm)]
        pm = os.path.join(tmp, "missing")
        write_plink(pm, GenotypeData(Gm, chm, pom, accm, ploidy=2))
        phm = os.path.join(tmp, "pheno_m.csv")
        PhenotypeData.from_arrays(1, "trait", accm, ym).write_to_file(phm)
        for km in ("ibs", "vanraden"):
            for k in kernels:
                k.launches = 0
            kw = dict(data_format="plink", plots=False, kinship_method=km)
            a = api.run_gwas(pm + ".bed", phm, **kw)
            if ibs_gram_packed.launches:
                raise AssertionError(f"{km} with missing calls launched K1")
            b = api.run_gwas(pm + ".bed", phm, device="cpu", **kw)
            g2 = a["genotype"]
            if not (g2.matrix < 0).any() or g2.ploidy != 2:
                raise AssertionError("the missing-call fileset lost its "
                                     "missing calls or its ploidy")
            dK = float(np.abs(cached_kinship(g2, km)
                              - cached_kinship(g2, km, device="cpu")).max())
            dp = float(np.abs(a["scan"]["ps"] - b["scan"]["ps"]).max())
            timings = {k: round(v, 3) for k, v in a["timings"].items()}
            print(f"run_gwas kinship_method={km}, 2 % missing calls, "
                  f"n={g2.num_samples} M={g2.num_snps}: card float32 vs CPU "
                  f"float64 max|dK| {dK:.3e}, max|dp| {dp:.3e}; card "
                  f"timings_s {json.dumps(timings)}", flush=True)
            if dK > 1e-5 or dp > 1e-4 or not np.array_equal(
                    a["scan"]["mask"], b["scan"]["mask"]):
                raise AssertionError(f"{km}: card and CPU disagree")
        # LOCO's float kinships (VanRaden over these missing calls) in
        # float64 on the card: K_loco of the middle chromosome against the
        # direct kinship over the other chromosomes' rows
        ch_m = np.asarray(g2.chromosomes)
        c_mid = np.unique(ch_m)[len(np.unique(ch_m)) // 2]
        K_v = loco_kinships(ResidentGenome.from_source(g2), ch_m,
                            method="vanraden", dtype=torch.float64)[c_mid]
        rest = ResidentGenome.from_source(g2.matrix[ch_m != c_mid],
                                          ploidy=g2.ploidy)
        dk = float(np.abs(K_v - scale_k(kinship_resident(
            rest, method="vanraden", dtype=torch.float64))).max())
        print(f"VanRaden K_loco identity over missing calls (float64 on the "
              f"card), chromosome {c_mid}: max|d| {dk:.3e}", flush=True)
        if dk > 1e-12:
            raise AssertionError("VanRaden K_loco differs from the direct "
                                 "kinship")
        print(f"missing-call and VanRaden runs: "
              f"{time.perf_counter() - ts:.3f} s", flush=True)

        # VanRaden's K with delta at its lower bound: the float32 exact scan
        # against the float64 CPU path (ROADMAP Queue 3's repaired fault)
        ts = time.perf_counter()
        Gv, chv, pov = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
        accv = [f"s{i}" for i in range(256)]
        yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
        gv, pv = os.path.join(tmp, "v.csv"), os.path.join(tmp, "v_p.csv")
        GenotypeData(Gv, chv, pov, accv, ploidy=1).write_csv(gv)
        PhenotypeData.from_arrays(1, "t", accv, yv).write_to_file(pv)
        kv = dict(kinship_method="vanraden", plots=False)
        ref_v = api.run_gwas(gv, pv, device="cpu", **kv)["scan"]
        for tier in ("exact", "int8x3", "bf16x3"):
            sv = api.run_gwas(gv, pv, precision=tier, **kv)["scan"]
            diff = sv["mask"] != ref_v["mask"]
            dpv = np.abs(sv["ps"] - ref_v["ps"])
            print(f"VanRaden K, delta {ref_v['delta']:.3e} (its bound), "
                  f"{tier} on the card vs float64 CPU: {int(diff.sum())} "
                  f"mask(s) differ, max|dp| {dpv.max():.3e}, where the "
                  f"masks agree {dpv[~diff].max():.3e}", flush=True)
            if tier == "exact" and (diff.any() or dpv.max() > 1e-4):
                raise AssertionError("the float32 exact scan under a "
                                     "singular K disagrees with float64")
        print(f"singular-K runs: {time.perf_counter() - ts:.3f} s",
              flush=True)

        # stepwise through the facade, from phase 6's PLINK fileset
        for k in kernels:
            k.launches = 0
        sw_out = api.run_gwas(files[0], files[1], data_format="plink",
                              method="emmax_stepwise", num_steps=3,
                              plots=False, out_prefix=os.path.join(tmp, "sw"))
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        with open(sw_out["files"]["summary"]) as f:
            timings = json.load(f)["timings_s"]
        sel = {k: v["cofactors"] for k, v in
               sw_out["scan"]["stepwise"]["selected"].items()}
        print(f"run_gwas emmax_stepwise (3 steps) n={n} "
              f"M={sw_out['genotype'].num_snps}: timings_s "
              f"{json.dumps(timings)}; selected {json.dumps(sel)}; "
              f"launches {run}", flush=True)
        if run["scan_stats"] <= 0 or sw_out["scan"]["ps"] is not None:
            raise AssertionError("run_gwas emmax_stepwise: no K3 launch")

        # LOCO with the VanRaden kinship on the same rows
        ts = time.perf_counter()
        gd_f = sw_out["genotype"]
        rg_f = ResidentGenome.from_source(gd_f)
        ch_f = np.asarray(gd_f.chromosomes)
        for k in kernels:
            k.launches = 0
        lv = emmax_loco(rg_f, sw_out["y"], chromosomes=ch_f,
                        method="vanraden")
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        print(f"emmax_loco vanraden (M={rg_f.M}): "
              f"{time.perf_counter() - ts:.3f} s; launches {run}; deltas "
              f"{[round(v['delta'], 6) for v in lv['loco'].values()]}",
              flush=True)
        if (run["scan_stats"] <= 0 or not np.isfinite(lv["ps"]).all()
                or lv["ps"].shape != (rg_f.M,)):
            raise AssertionError("LOCO vanraden: malformed")
        del rg_f, sw_out, gd_f
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("7 facade", t0)

    # ---- 8. stepwise MLMM at full width -----------------------------------
    t0 = time.perf_counter()
    sw = {}
    for route, kw in (("stored", dict(max_steps=10)),
                      ("over budget", dict(max_steps=3,
                                           rot_budget_bytes=1 << 30))):
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        r = emmax_step_wise(main["rg"], main["y"], eig_k=main["eig"], **kw)
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        tm = r["timings_s"]
        print(f"stepwise {route} ({tm['route']}, {kw['max_steps']} steps, "
              f"n={n} M={M}): {wall:.3f} s; rotation {tm['rotate']:.3f} s; "
              f"scan a step {np.mean(tm['scan']):.3f} s (host p-values "
              f"included); K3 launches {run['scan_stats']}; path "
              f"{[s['min_p_snp'] for s in r['steps'] if s['min_p_snp'] >= 0]}"
              f"; selected ebic {r['selected']['ebic']['cofactors']}",
              flush=True)
        if run["scan_stats"] <= 0:
            raise AssertionError(f"stepwise {route}: K3 never launched")
        sw[route] = r
    fa = [s for s in sw["stored"]["steps"] if s["phase"] == "forward"][:3]
    fb = [s for s in sw["over budget"]["steps"]
          if s["phase"] == "forward"][:3]
    if [s["min_p_snp"] for s in fa] != [s["min_p_snp"] for s in fb]:
        raise AssertionError("the stepwise routes chose other cofactors")
    rel = max(abs(a["min_p"] - b["min_p"]) / b["min_p"]
              for a, b in zip(fa, fb))
    print(f"stored vs over-budget: the same 3 cofactors, forward min_p "
          f"{[s['min_p'] for s in fa]} and {[s['min_p'] for s in fb]}, "
          f"within rtol {rel:.3e}", flush=True)
    if rel > 1e-4:
        raise AssertionError("the stepwise routes' min_p disagree")
    del main, sw
    torch.cuda.empty_cache()
    # the card (float32) against the float64 CPU path
    ts = time.perf_counter()
    Gs, _, _ = simulate_genotypes(1_024, 8_192, ploidy=1, seed=args.seed + 8)
    ys, _ = simulate_phenotype(Gs, h2=0.6, n_causal=4, seed=args.seed + 8)
    Ks = scale_k(kinship_resident(ResidentGenome.from_source(Gs)))
    a = emmax_step_wise(Gs, ys, K=Ks, max_steps=3, save_scans=True)
    b = emmax_step_wise(Gs, ys, K=Ks, max_steps=3, save_scans=True,
                        device="cpu")
    pa, pb = a["steps"][0]["scan_ps"], b["steps"][0]["scan_ps"]
    dps = float(np.abs(pa - pb).max())
    print(f"stepwise card f32 vs CPU f64 (n=1024, M=8192, 3 steps): path "
          f"{[s['cofactors'] for s in a['steps']]}; step 0 max|dp| "
          f"{dps:.3e} ({time.perf_counter() - ts:.3f} s)", flush=True)
    if ([s["cofactors"] for s in a["steps"]]
            != [s["cofactors"] for s in b["steps"]]
            or a["selected"] != b["selected"] or dps > 1e-5
            or not np.array_equal(pa < 1.0, pb < 1.0)):
        raise AssertionError("stepwise: card and CPU disagree")
    _check_no_jax()
    _phase("8 stepwise", t0)

    for k in kernels:
        report[k.__name__]["launches"] = launches[k.__name__]
    meta = {
        "ibs_gram_packed": ("cuda", "mixmogam_tpu_torch/csrc/ibs_gram.cu",
                            "mixmogam_tpu/ops/pallas_kinship.py:60"),
        "rotate_scan_int8_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/rotate_scan_int8.cu",
            "mixmogam_tpu/ops/pallas_scan.py:369"),
        "scan_stats": ("cuda", "mixmogam_tpu_torch/csrc/scan_stats.cu",
                       "mixmogam_tpu/ops/pallas_scan.py:108"),
        "ibs_gram_tri_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/ibs_gram_tri.cu",
            "mixmogam_tpu/ops/pallas_kinship.py:112"),
        "rotate_scan_bf16_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/rotate_scan_bf16.cu",
            "mixmogam_tpu/ops/pallas_scan.py:221"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": meta[name][0], "source": meta[name][1],
         "replaces": meta[name][2], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in report.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
