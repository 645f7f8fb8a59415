"""Where one run_gwas call of the PyTorch/CUDA port spends its wall time,
and how long the card is busy in it.

  python3 scripts/torch_facade_profile.py                 # n = 10,240 x 65,536
  python3 scripts/torch_facade_profile.py --snps 262144

Simulates a binary genome from a seed, writes it as a PLINK fileset (the
facade then reads diploid 0/1 calls) with a phenotype CSV, builds the five
kernels, and runs mixmogam_tpu_torch.api.run_gwas from those files on the
card, under torch.profiler (CUDA activities only), once for each of:
method='emmax' at 'exact' and at 'int8x3', and method='emmax_loco'. For
each call it prints one JSON line: the call's timings_s (parse,
coordinate, kinship, scan, total), the card's busy seconds (the sum of
every kernel's and copy's device time), the idle share 1 - busy / total,
and the five largest device entries. Needs an NVIDIA card; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--snps", type=int, default=65_536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_facade_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    import numpy as np
    import scipy.stats  # noqa: F401  (seconds to import: not in a timed call)
    from torch.profiler import ProfilerActivity, profile

    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.plink import write_plink
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.ops import _build

    n, M = args.samples, args.snps
    _build.build_all(("ibs_gram", "ibs_gram_tri", "rotate_scan_int8",
                      "rotate_scan_bf16", "scan_stats"))
    G, _, _ = simulate_genotypes(n, M, ploidy=1, seed=args.seed)
    y, _ = simulate_phenotype(G[:16_384], h2=0.6, n_causal=10,
                              causal_effect=1.0, seed=args.seed)
    acc = [f"acc{i}" for i in range(n)]
    # 5 chromosomes in proportion to the Arabidopsis TAIR10 lengths
    mb = np.array([30.43, 19.70, 23.46, 18.59, 26.98])
    ends = np.round(np.cumsum(mb) / mb.sum() * M).astype(int)
    chrom = np.repeat(np.arange(1, 6), np.diff(np.r_[0, ends]))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "cohort")
        write_plink(prefix, GenotypeData(G, chrom, np.arange(1, M + 1) * 100,
                                         acc, ploidy=1))
        pheno = os.path.join(tmp, "pheno.csv")
        PhenotypeData.from_arrays(1, "trait", acc, y).write_to_file(pheno)
        del G
        for label, kw in (("emmax exact", {}),
                          ("emmax int8x3", {"precision": "int8x3"}),
                          ("emmax_loco exact", {"method": "emmax_loco"})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = api.run_gwas(prefix + ".bed", pheno,
                                   data_format="plink", plots=False,
                                   out_prefix=os.path.join(tmp, "out"), **kw)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                           for e in prof.key_averages()), reverse=True)
            busy = sum(r[0] for r in rows)
            if busy <= 0:
                raise AssertionError("the profiler saw no device time")
            print(json.dumps({
                "call": f"run_gwas {label}", "n": out["genotype"].num_samples,
                "M": out["genotype"].num_snps,
                "device": torch.cuda.get_device_name(0),
                "timings_s": {k: round(v, 3)
                              for k, v in out["timings"].items()},
                "wall_s": round(wall, 3), "device_busy_s": round(busy, 3),
                "idle_share": round(1.0 - busy / wall, 4),
                "top_device_entries": [
                    {"s": round(s, 3), "count": c, "name": k[:60]}
                    for s, c, k in rows[:5]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
