"""Kernel K3 (csrc/scan_stats.cu) by Q0 width, and the REML that feeds
stepwise's scans, on one NVIDIA card.

K3 has two paths: q <= 16 keeps each row's Q0 sums in registers (Q0
zero-padded to 1, 2, 4, 8 or 16 columns), 16 < q <= 128 stages Q0 in
shared memory (padded to 32, 64 or 128). This script times both paths
where both can run (q <= 16: the register path at its own width against the
wide path at 32 columns), and the wide path alone above 16, at n = 10,240 on
one 16,384-row tile, each checked against scan_stats_plain (identical
masks, f within rtol/atol 1e-4). Then ops/xreml.py::explicit_reml at the
same n, on the card (its first call in the process, then the mean of three)
and on the CPU, for a design of 1 and of 11 columns.

  python3 scripts/torch_k3_paths.py [--samples N] [--rows R]

Prints the card's name and power limit first; exits non-zero without a
card or when a path disagrees with the plain version.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


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
    from mixmogam_tpu_torch.ops._build import build, check_launch
    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats_plain
    from mixmogam_tpu_torch.ops.xreml import explicit_reml

    dev = torch.device("cuda")
    n, m = args.samples, args.rows
    g = torch.Generator(device=dev).manual_seed(0)
    Xr = torch.randn(m, n, generator=g, device=dev)
    sd = torch.rand(n, generator=g, device=dev) + 0.5
    fn = build("scan_stats").scan_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]

    def launch(y_res, Q0, qp, rss0, dof):
        q0 = torch.zeros((n, qp), device=dev)
        q0[:, :Q0.shape[1]] = Q0
        out = torch.empty((4, m), device=dev)
        check_launch(fn(Xr.data_ptr(), m, n, sd.data_ptr(), y_res.data_ptr(),
                        q0.data_ptr(), qp, rss0, dof, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "scan_stats")
        return out

    bad = False
    for q in (1, 2, 4, 8, 11, 16, 17, 32, 64, 128):
        Q0, _ = torch.linalg.qr(torch.randn(n, q, generator=g, device=dev))
        y = torch.randn(n, generator=g, device=dev)
        y_res = y - Q0 @ (Q0.T @ y)
        rss0, dof = float(y_res @ y_res), float(n - q - 1)
        ref = scan_stats_plain(Xr, sd, y_res, Q0, rss0, dof)
        own = max(1 << (q - 1).bit_length(), 32 if q > 16 else 1)
        line = [f"K3 q={q} n={n} rows={m}:"]
        for qp in sorted({own, max(own, 32)}):
            got = launch(y_res, Q0, qp, rss0, dof)
            ok = (torch.equal(got[3] > 0.5, ref[3] > 0.5) and torch.allclose(
                got[0], ref[0], rtol=1e-4, atol=1e-4))
            bad |= not ok
            ms = _cuda_ms(lambda: launch(y_res, Q0, qp, rss0, dof))
            path = "registers" if qp <= 16 else "shared"
            line.append(f"{path} (Q0 padded to {qp}) {ms:.3f} ms"
                        f"{'' if ok else ' DISAGREES'}")
        print(" ".join(line), flush=True)

    for p in (1, 11):
        rng = torch.Generator().manual_seed(p)
        phi = torch.rand(n, generator=rng, dtype=torch.float64) * 2
        yr = torch.randn(n, generator=rng, dtype=torch.float64)
        Xd = torch.randn(n, p, generator=rng, dtype=torch.float64)
        for where in ("cuda", "cpu"):
            a = [t.to(where) for t in (phi, yr, Xd)]
            times = []
            for _ in range(4):
                ts = time.perf_counter()
                r = explicit_reml(*a)
                float(r["delta"])
                times.append(time.perf_counter() - ts)
            print(f"explicit_reml n={n} p={p} on {where}: first "
                  f"{times[0]:.3f} s, then {sum(times[1:]) / 3:.3f} s a call",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
