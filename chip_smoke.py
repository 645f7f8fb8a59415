"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

  python3 chip_smoke.py                  # n = 10,240 samples x 262,144 SNPs
  python3 chip_smoke.py --snps 1048576   # the BASELINE #3 shape

Phases (each prints its own seconds):
  1 device check: fails without CUDA; prints the card's name and power
    limit as nvidia-smi reports them
  2 build the three CUDA kernels from mixmogam_tpu_torch/csrc
  3 each kernel against its plain PyTorch version on the card, at the
    main path's shapes (K1 bit-equal for ploidy 1 and 2; K2 int8x3 and
    K3 within f rtol 1e-4 / atol 1e-4, beta atol 1e-5, identical masks)
  4 the main path at full width: simulate -> ResidentGenome on the card
    -> kinship_resident (K1) -> scale_k -> eigh on the card (float64)
    -> fit_null_model -> emmax_resident at 'exact' (K3) and 'int8x3'
    (K2); every kernel's launch count must be > 0
  5 end-to-end accuracy: exact-tier emmax on the card vs the port's
    float64 CPU path at n = 2,048 x 8,192 (max |dp| <= 1e-5, same masks)

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Any
failed phase exits non-zero before either is printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--snps", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
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

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.oracle.kinship import scale_k
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    emmax_scan_packed,
                                                    kinship_resident)
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.eigen import eigen_k
    from mixmogam_tpu_torch.ops.hopper_kinship import (
        ibs_gram_packed, ibs_gram_packed_plain)
    from mixmogam_tpu_torch.ops.hopper_scan import (
        rotate_scan_int8_packed, rotate_scan_int8_packed_plain, scan_stats,
        scan_stats_plain)
    from mixmogam_tpu_torch.ops.reml import NullModel, fit_null_model
    from mixmogam_tpu_torch.ops.scan import build_rotated_null

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dev = torch.device("cuda")
    _phase("1 device check", t0)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    for name in ("ibs_gram", "rotate_scan_int8", "scan_stats"):
        tb = time.perf_counter()
        _build.build(name)
        print(f"built {name}.cu in {time.perf_counter() - tb:.3f} s",
              flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
    _phase("2 build", t0)

    # ---- 3. kernels vs plain versions on the card -------------------------
    t0 = time.perf_counter()
    # the kernels see the main path's widths: all n samples, and one
    # resident tile of SNP rows
    n, rows = args.samples, min(16_384, args.snps)
    report = {}
    for ploidy in (1, 2):
        Gc, _, _ = simulate_genotypes(n, rows, ploidy=ploidy,
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
        if ploidy == 1:
            report["ibs_gram_packed"] = dict(max_abs_err=0.0, ms=ms,
                                             plain_ms=pms)
            G1, rg1 = Gc, rgc
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
    rot8 = build_rotated_null(null, rotate_dtype="int8x3")
    a8 = (rg1.packed, n, rot8.planes, rot8.w_scale, rot8.y_res, rot8.Q0,
          rot8.rss0, rot8.dof)
    err = _check_stats("K2 int8x3", rotate_scan_int8_packed(*a8),
                       rotate_scan_int8_packed_plain(*a8))
    ms = _cuda_ms(lambda: rotate_scan_int8_packed(*a8))
    pms = _cuda_ms(lambda: rotate_scan_int8_packed_plain(*a8))
    report["rotate_scan_int8_packed"] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=pms)
    print(f"K2 rotate_scan_int8_packed int8x3 n={n} rows={rows}: max|df| "
          f"{err:.3e}, kernel {ms:.3f} ms, plain {pms:.3f} ms", flush=True)
    rot = build_rotated_null(null)
    Xr = torch.as_tensor(G1, device=dev).float() @ rot.U
    a3 = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    err = _check_stats("K3 scan_stats", scan_stats(*a3),
                       scan_stats_plain(*a3))
    ms = _cuda_ms(lambda: scan_stats(*a3))
    pms = _cuda_ms(lambda: scan_stats_plain(*a3))
    report["scan_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    print(f"K3 scan_stats n={n} rows={rows}: max|df| {err:.3e}, kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms", flush=True)
    del Xr, a3, a8, rot8, rot, null, U, rg1, rgc, G1, Gc, S, S_ref
    torch.cuda.empty_cache()
    _phase("3 kernels vs plain", t0)

    # ---- 4. main path at full width --------------------------------------
    t0 = time.perf_counter()
    M = args.snps
    ts = time.perf_counter()
    G, _, _ = simulate_genotypes(n, M, ploidy=1, seed=args.seed)
    y, causal = simulate_phenotype(G[:16_384], h2=0.6, n_causal=10,
                                   causal_effect=1.0, seed=args.seed)
    print(f"simulate {M} x {n}: {time.perf_counter() - ts:.3f} s",
          flush=True)
    kernels = (ibs_gram_packed, rotate_scan_int8_packed, scan_stats)
    for k in kernels:
        k.launches = 0
    ts = time.perf_counter()
    rg = ResidentGenome.from_source(G, device=dev)
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
    ts = time.perf_counter()
    null = fit_null_model(y, np.ones((n, 1)), eig_k=(phi, U), device=dev,
                          dtype=torch.float32)
    print(f"fit_null_model: {time.perf_counter() - ts:.3f} s "
          f"(h2 {float(null.pseudo_heritability):.4f})", flush=True)
    res = {}
    for tier in ("exact", "int8x3"):
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
        if cnt <= 0:
            raise AssertionError(f"main path never launched {name}")
    ex, i8 = res["exact"], res["int8x3"]
    for tier, r in res.items():
        ps = r["ps"]
        if ps.shape != (M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"{tier}: p-values malformed")
        if r["dof"] != n - 2:
            raise AssertionError(f"{tier}: dof {r['dof']} != {n - 2}")
    dp = float(np.abs(i8["ps"] - ex["ps"]).max())
    top = set(np.argsort(ex["ps"])[:20].tolist())
    hits = len(top & set(causal.tolist()))
    print(f"int8x3 vs exact: max|dp| {dp:.3e}; causal SNPs among the "
          f"exact top 20: {hits} of {len(causal)}", flush=True)
    if dp > 1e-4 or hits < 3:
        raise AssertionError("main path results off")
    del rg, G, K, phi, U, null, res, ex, i8
    torch.cuda.empty_cache()
    _phase("4 main path", t0)

    # ---- 5. end-to-end accuracy vs the float64 CPU path -------------------
    t0 = time.perf_counter()
    na, Ma = 2_048, 8_192
    Ga, _, _ = simulate_genotypes(na, Ma, ploidy=1, seed=args.seed + 1)
    ya, _ = simulate_phenotype(Ga, h2=0.5, n_causal=5, seed=args.seed + 1)
    Ka = scale_k(kinship_resident(ResidentGenome.from_source(Ga)))
    eig = eigen_k(Ka)
    a = emmax(Ga, ya, eig_k=eig, device="cuda")
    b = emmax(Ga, ya, eig_k=eig, device="cpu")
    dpa = float(np.abs(a["ps"] - b["ps"]).max())
    print(f"emmax exact, card f32 vs CPU f64 (n={na}, M={Ma}): "
          f"max|dp| {dpa:.3e}", flush=True)
    if dpa > 1e-5 or not np.array_equal(a["mask"], b["mask"]):
        raise AssertionError("card vs CPU p-values disagree")
    _phase("5 accuracy vs CPU float64", t0)

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
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": meta[name][0], "source": meta[name][1],
         "replaces": meta[name][2], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for name, r in report.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
