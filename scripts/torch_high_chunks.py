"""The 'high' tier's bf16 products on imputed rows, by contraction chunk,
on one NVIDIA card.

ops/rotate.py::rotate_high runs the three bf16 passes of the 'high' tier
(G_hi U_lo + G_lo U_hi) + G_hi U_hi with float32 outputs; on float rows
it cuts the n contraction samples into chunks and adds each chunk's
product in cuBLAS's FMA epilogue (torch.addmm). This script measures what
the chunk size buys and costs, at chip_smoke.py phase 3's shape (n =
10,240 samples, one 16,384-row tile; a random orthonormal U from --seed,
the intercept design): for each draw (its seed: the integer rows of
chip_smoke.py's genotype model, imputed as g * 0.97 + 0.01 + U(-0.01,
0.01), a trait y), for each chunk size set as ops/rotate.py::HIGH_CHUNK
(0: the whole contraction in one product a pass),

  - max |d| / sum |g u| of the products against their float64 values on
    the same bf16 splits (ops/scan.py::apply_rotation_high);
  - max |dbeta| and max |df| of kernel K3 on them (with the exact tier's
    mask) against the plain version (the float64 products rounded to
    float32 and summed in float32, then scan_stats_plain), the gate chip_smoke.py phase 3 holds
    at beta 1e-5;
  - the products' device time (CUDA events, mean of 3 after a warm-up);

beside the exact tier's fp32 GEMM against float64 products of the
unsplit operands (its max |dbeta|, its time) and the integer rows' two
passes (one product a pass). Prints the card's name and power limit
first and every figure as one JSON line last.

  python3 scripts/torch_high_chunks.py [--draws 11 12 13] [--chunks 0 4096 2048]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--rows", type=int, default=16_384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, nargs="+", default=[11, 12, 13, 14,
                                                             15])
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=[0, 4_096, 2_048, 1_024, 512])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from chip_smoke import _cuda_ms, _draw_genotypes
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.hopper_scan import (scan_stats,
                                                    scan_stats_plain)
    from mixmogam_tpu_torch.ops.reml import NullModel
    from mixmogam_tpu_torch.ops import rotate
    from mixmogam_tpu_torch.ops.rotate import rotate_high
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_high,
                                             build_rotated_null,
                                             outside_design,
                                             split_high)

    ts = time.perf_counter()
    _build.build_all(("scan_stats",))
    print(f"built K3 in {time.perf_counter() - ts:.1f} s", flush=True)
    dev = torch.device("cuda")
    n, rows = args.samples, args.rows
    g = torch.Generator(device=dev).manual_seed(args.seed)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev))
    phi = torch.sort(torch.rand(n, generator=g, device=dev) * 2.0,
                     descending=True).values
    one = torch.ones((), device=dev)
    report = []
    for seed in args.draws:
        gd = torch.Generator(device=dev).manual_seed(seed)
        null = NullModel(phi=phi, U=U, delta=one, log_delta=0 * one, ll=one,
                         sigma_g2=one, sigma_e2=one,
                         pseudo_heritability=one / 2,
                         y=torch.randn(n, generator=gd, device=dev),
                         X0=torch.ones((n, 1), device=dev))
        rot = build_rotated_null(null, matmul_precision="high")
        G8 = torch.as_tensor(_draw_genotypes(n, rows, seed=seed), device=dev)
        noise = torch.rand(G8.shape, generator=gd, device=dev)
        Gt = G8.float() * 0.97 + 0.01 + (noise - 0.5) * 0.02
        del noise
        a3 = (rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
        row = {"seed": seed, "n": n, "rows": rows, "chunks": {}}
        for kind, G in (("integer", G8), ("imputed", Gt)):
            keep = outside_design(G.float(), rot.X0, rot.X0p)

            def stats(X, fn):
                return torch.where(keep[None, :], fn(X, *a3), 0.0)

            X64 = apply_rotation_high(G, rot.high, torch.float64)
            mag = apply_rotation_high(G.abs(), rot.high.abs(), torch.float64)
            ref = stats(apply_rotation_high(G, rot.high, torch.float32),
                        scan_stats_plain)
            Xe = G.float() @ rot.U
            ex = stats(Xe, scan_stats)
            db_ex = float((ex[1] - stats((G.double() @ rot.U.double())
                                         .float(), scan_stats_plain)[1])
                          .abs().max())
            row[f"{kind}_exact_dbeta"] = db_ex
            row[f"{kind}_exact_gemm_ms"] = _cuda_ms(lambda: G.float()
                                                    @ rot.U)
            del Xe, ex
            for c in (args.chunks if kind == "imputed" else [0]):
                rotate.HIGH_CHUNK = c or n
                Xc = rotate_high(G, rot.high, torch.float32)
                ratio = float(((Xc.double() - X64).abs()
                               / mag.clamp_min(1e-300)).max())
                got = stats(Xc, scan_stats)
                if not torch.equal(got[3] > 0.5, ref[3] > 0.5):
                    raise AssertionError(f"{kind} chunk {c}: masks differ")
                cell = dict(
                    ratio=ratio,
                    dbeta=float((got[1] - ref[1]).abs().max()),
                    df=float((got[0] - ref[0]).abs().max()),
                    ms=_cuda_ms(lambda: rotate_high(G, rot.high,
                                                    torch.float32)))
                row["chunks"][f"{kind} {c}"] = cell
                print(f"seed {seed} {kind} rows, chunk {c or 'whole'}: max "
                      f"|d| / sum|g u| {ratio:.3e}, K3 max |dbeta| "
                      f"{cell['dbeta']:.3e} max |df| {cell['df']:.3e}; "
                      f"products {cell['ms']:.3f} ms (exact tier's fp32 "
                      f"GEMM max |dbeta| {db_ex:.3e}, "
                      f"{row[kind + '_exact_gemm_ms']:.3f} ms)", flush=True)
                del Xc, got
            del X64, mag, ref
        # the unchunked products the port ran before the chunks (mm, +=):
        # is one whole addmm chunk bit-equal to them?
        Gh, Gl = split_high(Gt)
        old = torch.mm(Gh, rot.high[1], out_dtype=torch.float32)
        old += torch.mm(Gl, rot.high[0], out_dtype=torch.float32)
        old += torch.mm(Gh, rot.high[0], out_dtype=torch.float32)
        rotate.HIGH_CHUNK = n
        row["whole_equals_mm_add"] = bool(torch.equal(
            old, rotate_high(Gt, rot.high, torch.float32)))
        print(f"seed {seed}: one whole chunk bit-equal to mm, +=: "
              f"{row['whole_equals_mm_add']}", flush=True)
        report.append(row)
        del G8, Gt, Gh, Gl, old, rot
        torch.cuda.empty_cache()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
