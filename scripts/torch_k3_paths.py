"""Kernel K3 (csrc/scan_stats.cu) by Q0 width, on one NVIDIA card.

K3 is one staged kernel for 1 <= q <= 128, templated on Q0's width class
(8, 16, 32, 64, 96, 128 columns). This script builds it (printing ptxas's
register and spill report), then at n = 10,240 on one 16,384-row tile, for
each width: the kernel against scan_stats_plain (f rtol/atol 1e-4, beta
atol 1e-5, identical masks), two launches bit-equal, and its time (mean of
5 launches after a warm-up, CUDA events) beside its bound: the larger of
the bytes (Xr, sd, y_res, Q0 and the output once) over 3.35 TB/s and
2 m n (2 + q) fp32 operations over 67 TFLOP/s. Then the edges: m = 1,
m = 1,001 rows, n = 2,042 (an 8,168-byte row pitch: 8-byte copies), a
padded pitch (a view of n columns of wider rows), a strided start (4-byte
copies), and 40,000 rows (more row blocks than SMs).

  python3 scripts/torch_k3_paths.py [--samples N] [--rows R]

Prints the card's name and power limit first; exits non-zero without a
card or when the kernel disagrees with the plain version.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the widths of chip_smoke.py's phase 3 sweep, and 96
WIDTHS = (1, 2, 4, 8, 11, 16, 20, 32, 64, 96, 128)


def _cuda_ms(fn, reps: int = 5) -> float:
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


def _problem(n, q, seed, dev):
    """(sd, y_res, Q0, rss0, dof): Q0 orthonormal, y_res orthogonal to it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    sd = torch.rand(n, generator=g, device=dev) + 0.5
    Q0, _ = torch.linalg.qr(torch.randn(n, q, generator=g, device=dev))
    y = torch.randn(n, generator=g, device=dev)
    y_res = y - Q0 @ (Q0.T @ y)
    return sd, y_res, Q0, float(y_res @ y_res), float(n - q - 1)


def check(name, Xr, args) -> str:
    """K3 on Xr against its plain version; raises on a disagreement."""
    import torch

    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats, scan_stats_plain

    got = scan_stats(Xr, *args)
    if not torch.equal(got, scan_stats(Xr, *args)):
        raise AssertionError(f"{name}: two launches differ")
    ref = scan_stats_plain(Xr, *args)
    g, r = got.double().cpu(), ref.double().cpu()
    nm = int(((g[3] > 0.5) != (r[3] > 0.5)).sum())
    df = (g[0] - r[0]).abs()
    db = float((g[1] - r[1]).abs().max())
    if nm or not bool((df <= 1e-4 + 1e-4 * r[0].abs()).all()) or db > 1e-5 \
            or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: {nm} masks differ, max|df| "
                             f"{float(df.max()):.3e}, max|dbeta| {db:.3e}")
    return f"max|df| {float(df.max()):.3e}, max|dbeta| {db:.3e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--rows", type=int, default=16_384)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats

    secs = _build.build_all(["scan_stats"])
    print(f"built scan_stats.cu in {secs['scan_stats']:.3f} s", flush=True)
    for line in _build.BUILD_LOG.get("scan_stats", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    n, m = args.samples, args.rows
    g = torch.Generator(device=dev).manual_seed(0)
    Xr = torch.randn(m, n, generator=g, device=dev)
    for q in WIDTHS:
        a = _problem(n, q, q, dev)
        res = check(f"K3 q={q}", Xr, a)
        ms = _cuda_ms(lambda: scan_stats(Xr, *a))
        by = (Xr.numel() + 2 * n + n * q + 4 * m) * 4
        t_b, t_o = by / 3.35e12 * 1e3, 2.0 * m * n * (2 + q) / 6.7e13 * 1e3
        bound = max(t_b, t_o)
        print(f"K3 q={q} n={n} rows={m}: {res}, bit-equal on repeat; "
              f"kernel {ms:.3f} ms, bound {bound:.3f} ms by "
              f"{'bytes' if t_b >= t_o else 'operations'} "
              f"({bound / ms:.2f} of it)", flush=True)
    # the edges
    a = _problem(n, 11, 7, dev)
    print(f"K3 m=1: {check('K3 m=1', Xr[:1], a)}", flush=True)
    print(f"K3 m=1,001: {check('K3 m=1001', Xr[:1001], a)}", flush=True)
    wide = torch.randn(1001, n + 8, generator=g, device=dev)
    print(f"K3 padded pitch ({n + 8} floats): "
          f"{check('K3 padded pitch', wide[:, :n], a)}", flush=True)
    a1 = _problem(n - 1, 11, 8, dev)
    print(f"K3 strided start (4-byte copies): "
          f"{check('K3 strided start', wide[:, 1:n], a1)}", flush=True)
    for nr, q in ((2_042, 1), (2_042, 20)):
        Xo = torch.randn(3_001, nr, generator=g, device=dev)
        print(f"K3 n={nr} (pitch {nr * 4} bytes) q={q}: "
              f"{check(f'K3 n={nr}', Xo, _problem(nr, q, 9, dev))}",
              flush=True)
    Xb = torch.randn(40_000, 2_048, generator=g, device=dev)
    ab = _problem(2_048, 128, 10, dev)
    print(f"K3 40,000 rows (313 row blocks) q=128: "
          f"{check('K3 40,000 rows', Xb, ab)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
