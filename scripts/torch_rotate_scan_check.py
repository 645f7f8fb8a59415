"""A short first call for the fused rotate + scan kernels (K2/K5 of
mixmogam_tpu_torch) on one NVIDIA card: build, check, time.

  1 builds csrc/rotate_scan_int8.cu and csrc/rotate_scan_bf16.cu and prints
    what ptxas says of registers, spills and serialized wgmma
  2 holds every tier against its plain version at small ragged shapes
    (pitches of 16, 33, 251 and 511 bytes; 1 to 900 rows; q = 1..16; with
    and without missing genotypes for K5)
  3 holds and times every tier at full width on the least launch that fills
    the card (one 256-row block an SM: 33,792 rows on an H100's 132) and on
    8 such in one launch (CUDA events, mean of 3 launches after a warm-up),
    at a 16-byte pitch (n = 10,240) and at one that is not (n = 10,236),
    with the operand prepared once, and checks that a second launch and the
    last eighth of the long one give the same bits

Run from the repository root; exits non-zero when a check fails:

  python3 scripts/torch_rotate_scan_check.py [--samples N [N ...]]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INT8_TIERS = ("int8x2", "int8x3", "int8x4")
BF16_TIERS = ("bf16", "bf16x2", "bf16x3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, nargs="+",
                    default=[10_240, 10_236])
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from mixmogam_tpu_torch.data.simulate import simulate_genotypes
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    row_means_packed)
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.hopper_scan import (
        rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain,
        rotate_scan_int8_packed, rotate_scan_int8_packed_plain, scan_operand)
    from mixmogam_tpu_torch.ops.reml import NullModel
    from mixmogam_tpu_torch.ops.scan import build_rotated_null

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rows = args.rows or 256 * torch.cuda.get_device_properties(
        dev).multi_processor_count

    # ---- 1. build ----------------------------------------------------------
    names = ("rotate_scan_int8", "rotate_scan_bf16")
    for name, sec in _build.build_all(names).items():
        print(f"built {name}.cu in {sec:.3f} s", flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                print(f"  ptxas: {line.strip()[:200]}", flush=True)

    def null_model(n, q, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev))
        X0 = torch.cat([torch.ones(n, 1, device=dev),
                        torch.randn(n, q - 1, generator=g, device=dev)],
                       dim=1)
        one = torch.ones((), device=dev)
        return NullModel(
            phi=torch.sort(torch.rand(n, generator=g, device=dev) * 2.0,
                           descending=True).values, U=U, delta=one,
            log_delta=0 * one, ll=one, sigma_g2=one, sigma_e2=one,
            pseudo_heritability=one / 2,
            y=torch.randn(n, generator=g, device=dev), X0=X0)

    def tier_call(tier, rot, packed, n, mu=None):
        """(kernel wrapper, plain version, their shared arguments)."""
        if tier in INT8_TIERS:
            return (rotate_scan_int8_packed, rotate_scan_int8_packed_plain,
                    (packed, n, rot.planes, rot.w_scale, rot.y_res, rot.Q0,
                     rot.rss0, rot.dof))
        return (rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain,
                (packed, n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof,
                 mu))

    def check(what, got, ref) -> bool:
        g, r = got.double().cpu(), ref.double().cpu()
        masks = int(((g[3] > 0.5) != (r[3] > 0.5)).sum())
        df = ((g[0] - r[0]).abs() / (1 + r[0].abs())).max().item()
        db = (g[1] - r[1]).abs().max().item()
        ok = masks == 0 and df <= 1e-4 and db <= 1e-5
        print(f"{'ok ' if ok else 'BAD'} {what}: masks differ in {masks} "
              f"rows, max |df| / (1 + |f|) {df:.3e}, max |dbeta| {db:.3e}",
              flush=True)
        return ok

    # ---- 2. small ragged shapes -----------------------------------------------
    good = True
    for n, q, m, miss in ((64, 1, 300, 0.0), (130, 3, 900, 0.03),
                          (1002, 2, 129, 0.0), (2042, 16, 700, 0.03),
                          (77, 5, 1, 0.0)):
        G, _, _ = simulate_genotypes(n, m, seed=n, missing_rate=miss)
        rg = ResidentGenome.from_source(G, tile=256, device=dev)
        packed = rg.packed[:m]
        null = null_model(n, q)
        mu = (row_means_packed(rg.packed, n, rg.tile, torch.float32)[:m]
              if miss else None)
        for tier in (BF16_TIERS if miss else INT8_TIERS + BF16_TIERS):
            rot = build_rotated_null(null, rotate_dtype=tier)
            fn, plain, a = tier_call(tier, rot, packed, n, mu)
            good &= check(f"{tier} n={n} q={q} rows={m} missing={miss}",
                          fn(*a), plain(*a))
    if not good:
        print("a small shape failed", file=sys.stderr)
        return 2

    # ---- 3. full width ---------------------------------------------------------
    def cuda_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    for n in args.samples:
        G, _, _ = simulate_genotypes(n, rows, seed=11)
        rg = ResidentGenome.from_source(G, tile=256, device=dev)
        big = torch.cat([rg.packed] * 8)
        null = null_model(n, 1)
        for tier in INT8_TIERS + BF16_TIERS:
            rot = build_rotated_null(null, rotate_dtype=tier)
            op = scan_operand(rot)
            fn, plain, a = tier_call(tier, rot, rg.packed, n)
            got = fn(*a, operand=op)
            good &= check(f"{tier} n={n} rows={rows}", got, plain(*a))
            m = rg.packed.shape[0]
            same = (torch.equal(got, fn(*a, operand=op)) and torch.equal(
                got, fn(big, *a[1:], operand=op)[:, -m:]))
            good &= same
            ms = cuda_ms(lambda: fn(*a, operand=op))
            ms8 = cuda_ms(lambda: fn(big, *a[1:], operand=op), reps=1)
            print(f"   {tier} n={n} (pitch {rg.packed.shape[1]}): "
                  f"{ms:.3f} ms a {m}-row launch, {ms8:.3f} ms for 8 such "
                  f"in one launch; a second launch and the long one's last "
                  f"eighth give {'the same bits' if same else 'OTHER BITS'}",
                  flush=True)
            del rot, op
    return 0 if good else 2


if __name__ == "__main__":
    sys.exit(main())
