"""Where the IBS gram kernel (K1/K4 of mixmogam_tpu_torch) spends its time.

Builds csrc/ibs_gram.cu several times on one NVIDIA card, each time with one
part of csrc/ibs_tile.cuh cut out of the source text, and times every build
on the same packed genome (CUDA events, mean of 5 launches after a warm-up):

  base            the kernel as committed (32-bit loads), and with its other
                  load path forced (wide = 0)
  no_mma          no wgmma: loads, unpack, epilogue
  no_unpack       no unpack of the later stages (the compiler then drops
                  their loads too): wgmma and epilogue
  no_loads        the later stages unpack the first stage's words again:
                  wgmma, unpack, epilogue
  no_mirror       the lower triangle is not stored
  no_stores       nothing of the n x n output is stored

A cut-down build computes wrong sums; only the base build is checked (it
must be bit-equal to the plain version). Run from the repository root:

  python3 scripts/torch_ibs_gram_ablation.py [--samples N] [--rows R]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MMA = ("      wgmma_m64n256k32_s8(acc, smem_desc(sa + ks * 2 * LBO_I, LBO_I),\n"
       "                          smem_desc(sb + ks * 2 * LBO_J, LBO_J));\n")
UNPACK = ("    if (decltype(store)::value) "
          "store_stage(smem + (cur ^ 1) * STAGE);\n")
LOADS = "    load_stage(how);\n"
DIRECT = "        if (i <= j) out[(long long)i * n + j] = v;\n"
MIRROR = ("      if (i < n && i < j) "
          "out[(long long)j * n + i] = T[jl * TP + il];\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--rows", type=int, default=16_384)
    args = ap.parse_args(argv)
    import torch

    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_packed_plain
    from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    with open(os.path.join(_build.CSRC, "ibs_tile.cuh")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC, "ibs_gram.cu")) as f:
        cu = f.read()
    for part in (MMA, UNPACK, LOADS, DIRECT, MIRROR):
        if src.count(part) != 1:
            raise SystemExit(f"ibs_tile.cuh no longer holds:\n{part}")
    variants = {
        "base": src,
        # (the operand addresses stay in use: the compiler fails without)
        "no_mma": src.replace(MMA, "      acc[ks] += (int32_t)(sa + sb);\n"),
        "no_unpack": src.replace(UNPACK, ""),
        "no_loads": src.replace(LOADS, ""),
        "no_mirror": src.replace(MIRROR, ""),
        "no_stores": src.replace(MIRROR, "").replace(
            DIRECT, "        if (v == 0x7fffffff) out[0] = v;\n"),
    }
    n, rows = args.samples, args.rows
    rb = (n + 3) // 4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    packed = {pl: pack_2bit_device(torch.randint(
        0, pl + 1, (rows, n), dtype=torch.int8, device=dev, generator=g))
        for pl in (1, 2)}
    out = torch.empty((n, n), dtype=torch.int32, device=dev)
    colsum = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn, reps=5):
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
        for name, header in variants.items():     # one nvcc each, together
            d = os.path.join(tmp, name)
            os.makedirs(d)
            for fn, text in (("ibs_tile.cuh", header), ("ibs_gram.cu", cu)):
                with open(os.path.join(d, fn), "w") as f:
                    f.write(text)
            procs.append((name, d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(d, "k.so"), os.path.join(d, "ibs_gram.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for name, d, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
            fn = ctypes.CDLL(os.path.join(d, "k.so")).ibs_gram_packed
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
            for pl in (1, 2):
                for wide in ((1, 0) if name == "base" else (1,)):
                    if wide and rb % 4:
                        continue

                    def run():
                        rc = fn(packed[pl].data_ptr(), rows, rb, n, rows, pl,
                                wide, colsum.data_ptr(), out.data_ptr(),
                                stream)
                        if rc:
                            raise RuntimeError(f"launch failed: {rc}")

                    ms = cuda_ms(run)
                    if name == "base" and not torch.equal(
                            out, ibs_gram_packed_plain(packed[pl], n, rows,
                                                       pl)):
                        raise SystemExit(f"base ploidy {pl} wide {wide}: "
                                         "not bit-equal to the plain version")
                    print(f"{name:10s} ploidy {pl} "
                          f"{'32-bit' if wide else 'other '} loads, n={n} "
                          f"rows={rows}: {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
