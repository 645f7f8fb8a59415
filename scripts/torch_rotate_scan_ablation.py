"""Where the fused rotate + scan kernels (K2/K5 of mixmogam_tpu_torch) spend
their time, and what K5's two accumulation candidates cost in accuracy.

Builds csrc/rotate_scan_int8.cu and csrc/rotate_scan_bf16.cu several times on
one NVIDIA card, each time with one part cut out of the source text, and
times every build on the same packed genome and rotated null at 'bf16',
'bf16x3' and 'int8x3' (CUDA events, mean of 3 launches after a warm-up):

  base         the kernels as committed
  no_mma       no wgmma: ring, decode, row sums
  no_decode    the A registers are the raw packed bits (no unpack / no byte
               permute): ring, wgmma, row sums
  no_w         the producer copies no W stage: packed rows, decode, wgmma on
               whatever shared memory holds, row sums
  no_g         the producer copies no packed bytes: W ring, decode of
               whatever shared memory holds, wgmma, row sums
  no_sums      no row sums after a column step (the last step's only)
  no_add       K5 only: the chunk sums are not added into the running sums
  each_part    K5 only, the other accumulation candidate: an IEEE add into
               the running sum after every part of a chunk, not one a chunk

A cut-down build computes wrong sums; base and each_part are held against
the plain version and their max |d beta| and max |d f| are printed. Run from
the repository root:

  python3 scripts/torch_rotate_scan_ablation.py [--samples N] [--rows R]

R defaults to one 256-row block for every SM of the card (33,792 rows on an
H100's 132): the least launch that fills it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MMA8 = ("          wgmma_m64n192k32_s8(s.acc[0], a[ks][0], db);\n"
        "          wgmma_m64n192k32_s8(s.acc[1], a[ks][1], db);\n")
MMA16 = ("        wgmma_m64n64k16_bf16(acc[0], a[ks][0], db, !first);\n"
         "        wgmma_m64n64k16_bf16(acc[1], a[ks][1], db, !first);\n")
DEC8 = "  w ^= m3 * 3u;\n"
DEC16 = ("          a[ks][mt][hh] = __byte_perm(lo, hi, sel01);"
         "      // k 2t, 2t+1\n"
         "          a[ks][mt][2 + hh] = __byte_perm(lo, hi, sel23);"
         "  // k 2t+8, 2t+9\n")
ADD = "    rscan::wgmma_wait<0>();\n    add(s, acc);\n    ring.release(cur);\n"
FIRST = "        const int first = ks == 0 && p == NP - 1;\n"
COMMIT = "      }\n    }\n    rscan::wgmma_commit();\n"
W_COPY = ("          bulk_load(smem_u32(st), wsrc + (long long)ks * P::W_STAGE,\n"
          "                    P::W_STAGE, full0 + 8 * slot);\n")
W_EXPECT = "          mbar_expect_tx(full0 + 8 * slot, P::W_STAGE);\n"
G_COPY = ("        load_g_stage<P::GB, P::ALIGNED>(a, r0, ks * P::GB, st + "
          "P::W_STAGE,\n                                        ptid, full0 + "
          "8 * slot);\n")
SUMS = ("      step_sums<P::CN / 8>(xs, js * P::CN, n_out_pad, warp, g, t4, a, "
        "ssum, xsum,\n                           cc);\n")


def _variants(tile: str, k2: str, k5: str):
    """name -> (header, K2 source, K5 source)."""
    for text, parts in ((tile, (W_COPY, W_EXPECT, G_COPY, SUMS)),
                        (k2, (MMA8, DEC8)),
                        (k5, (MMA16, DEC16, ADD, FIRST, COMMIT))):
        for part in parts:
            if text.count(part) != 1:
                raise SystemExit(f"the sources no longer hold:\n{part}")
    # (every cut keeps its operands in use, or the compiler drops more)
    no_mma8 = ("          s.acc[0][ks] += (int32_t)(a[ks][0][0] ^ a[ks][0][1]"
               " ^ a[ks][0][2] ^ a[ks][0][3] ^ (uint32_t)db);\n"
               "          s.acc[1][ks] += (int32_t)(a[ks][1][0] ^ a[ks][1][1]"
               " ^ a[ks][1][2] ^ a[ks][1][3] ^ (uint32_t)db);\n")
    no_mma16 = ("        acc[0][ks] = (first ? 0.f : acc[0][ks]) + (float)(a[ks][0]"
                "[0] ^ a[ks][0][1] ^ a[ks][0][2] ^ a[ks][0][3] ^ (uint32_t)db);\n"
                "        acc[1][ks] = (first ? 0.f : acc[1][ks]) + (float)(a[ks][1]"
                "[0] ^ a[ks][1][1] ^ a[ks][1][2] ^ a[ks][1][3] ^ (uint32_t)db);\n")
    return {
        "base": (tile, k2, k5),
        "no_mma": (tile, k2.replace(MMA8, no_mma8),
                   k5.replace(MMA16, no_mma16).replace(
                       "    float acc[2][32];\n",
                       "    float acc[2][32] = {};\n")),
        "no_decode": (tile,
                      k2.replace(DEC8, "  r[0] = w; r[1] = w >> 8; r[2] = w >> "
                                 "16; r[3] = w >> 24;\n  return;\n"),
                      k5.replace(DEC16, "          a[ks][mt][hh] = (w >> ks) ^ "
                                 "lo;\n          a[ks][mt][2 + hh] = (w >> ks) ^"
                                 " hi;\n")),
        "no_w": (tile.replace(W_COPY, "").replace(W_EXPECT, ""), k2, k5),
        "no_g": (tile.replace(G_COPY, "        mbar_arrive(full0 + 8 * slot);\n"),
                 k2, k5),
        "no_sums": (tile.replace(
            SUMS, "      if (js + 1 == a.n_steps) step_sums<P::CN / 8>(xs, js * "
            "P::CN, n_out_pad, warp, g, t4, a, ssum, xsum, cc);\n"),
            k2, k5),
        "no_add": (tile, k2, k5.replace(
            ADD, "    rscan::wgmma_wait<0>();\n    s.run[0][0] += acc[0][0] + "
            "acc[1][0];\n    ring.release(cur);\n")),
        "each_part": (tile, k2, k5.replace(FIRST, "        const int first = "
                                           "ks == 0;\n")
                      .replace(COMMIT, "      }\n      rscan::wgmma_commit();\n"
                               "      rscan::wgmma_wait<0>();\n"
                               "      add(s, acc);\n"
                               "      if (p > 0) rscan::wgmma_fence();\n    }\n")
                      .replace(ADD, "    ring.release(cur);\n")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.hopper_scan import (
        launch_rotate_scan, prepare_bf16_operand, prepare_int8_operand,
        rotate_scan_bf16_packed_plain, rotate_scan_int8_packed_plain)
    from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device
    from mixmogam_tpu_torch.ops.reml import NullModel
    from mixmogam_tpu_torch.ops.scan import build_rotated_null

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    src = {}
    for fn in ("rotate_scan_tile.cuh", "rotate_scan_int8.cu",
               "rotate_scan_bf16.cu"):
        with open(os.path.join(_build.CSRC, fn)) as f:
            src[fn] = f.read()
    variants = _variants(*src.values())

    dev = torch.device("cuda")
    n, rows = args.samples, args.rows or 256 * torch.cuda.get_device_properties(
        dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    packed = pack_2bit_device(torch.randint(
        0, 2, (rows, n), dtype=torch.int8, device=dev, generator=g))
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev))
    phi = torch.sort(torch.rand(n, generator=g, device=dev) * 2.0,
                     descending=True).values
    one = torch.ones((), device=dev)
    null = NullModel(phi=phi, U=U, delta=one, log_delta=0 * one, ll=one,
                     sigma_g2=one, sigma_e2=one, pseudo_heritability=one / 2,
                     y=torch.randn(n, generator=g, device=dev),
                     X0=torch.ones((n, 1), device=dev))
    tiers = {}
    for tier in ("bf16", "bf16x3", "int8x3"):
        rot = build_rotated_null(null, tier)
        if tier.startswith("int8"):
            op = prepare_int8_operand(rot.planes, rot.w_scale, rot.y_res,
                                      rot.Q0)
            ref = rotate_scan_int8_packed_plain(
                packed, n, rot.planes, rot.w_scale, rot.y_res, rot.Q0,
                rot.rss0, rot.dof)
        else:
            op = prepare_bf16_operand(rot.parts, rot.y_res, rot.Q0)
            ref = rotate_scan_bf16_packed_plain(
                packed, n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
        tiers[tier] = (op, float(rot.rss0), float(rot.dof), ref)
        del rot
    del U, null

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

    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name, (tile, k2, k5) in variants.items():  # all together
            d = os.path.join(tmp, name)
            os.makedirs(d)
            for fn, text in zip(src, (tile, k2, k5)):
                with open(os.path.join(d, fn), "w") as f:
                    f.write(text)
            for cu in ("rotate_scan_int8", "rotate_scan_bf16"):
                if name in ("each_part", "no_add") and cu == "rotate_scan_int8":
                    continue
                procs.append((name, cu, d, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                     os.path.join(d, cu + ".so"),
                     os.path.join(d, cu + ".cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        for name, cu, d, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name} {cu}: nvcc failed\n{log[-3000:]}")
            fn = getattr(ctypes.CDLL(os.path.join(d, cu + ".so")),
                         cu + "_packed")
            for tier, (op, rss0, dof, ref) in tiers.items():
                if tier.startswith("int8") != cu.endswith("int8"):
                    continue
                out = launch_rotate_scan(fn, packed, op, rss0, dof)
                ms = cuda_ms(lambda: launch_rotate_scan(fn, packed, op, rss0,
                                                        dof))
                note = ""
                if name in ("base", "each_part"):
                    d_f = (out[0] - ref[0]).abs().max().item()
                    d_b = (out[1] - ref[1]).abs().max().item()
                    same = torch.equal(out[3], ref[3])
                    note = (f"  max|d beta| {d_b:.3e} max|d f| {d_f:.3e} "
                            f"masks {'equal' if same else 'DIFFER'}")
                print(f"{name:10s} {tier:7s} n={n} rows={rows}: {ms:.3f} ms"
                      f"{note}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
