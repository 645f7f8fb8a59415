"""The 'sample' tensor-parallel scan over NCCL, one rank a card.

Spawns one process a rank (NCCL through tcp://localhost:<port>; gloo with
--device cpu, for a rehearsal), each drawing the same genome from --seed:
binary dosages of 3 populations, n samples x M SNPs. Rank 0 builds the
kinship and its eigh on its card (K and eig_k are needed on rank 0 only).
On the mesh of --shape (default (2, 2)) and on the SNP-only mesh
(world, 1) of the same ranks, each rank times distributed_kinship and,
at exact / int8x3 / bf16x3, distributed_emmax (in core) and
distributed_emmax_resident (a host-only container, each rank uploading
its rows x its byte block), and the campaign entry points:
emmax_step_wise (3 steps, in core), emmax_multi_trait (T = 4, exact in
core and int8x3 over the host-only container) and emmax_loco (the first
8,192 rows of n = 2,048 samples in 3 chromosomes, packed on the host;
its kinships and eighs on rank 0), and on the first 8,192 rows the
remaining entry points: emmax_gxe (E = 2, exact and int8x3 with an
exact rescore of its top 64), emmax_perm_test (P = 128), emmax_two_snps
(A = 2), emmax_anova (binary, and diploid on two blocks of rows summed)
and linear_model / anova / kruskal_wallis, distributed_train_step
(T = 4, top_k 8), and at precision='high' emmax_multi_trait (in core),
emmax_gxe (in core) and emmax_perm_test (over a host-only container of
those rows; on a 'sample' axis it must raise the JAX package's refusal),
synchronised, with a barrier before each call and
after a first, untimed call (the communicators' set-up);
and the bytes it handed all_reduce a call. The kernels are built before
the ranks start. Rank 0 then holds every result to one device's call on
its card (kinship_resident, emmax_resident, emmax_step_wise,
emmax_multi_trait, emmax_loco and the remaining entry points): the
integer kinship bit-equal, the class tests within 1e-12, masks equal, max |dp|
within the tier's TIER_P_DRIFT entry (GxE's GXE_P_DRIFT; exact: 1e-5, float32
partial sums in other shapes; 'high': bf16x3's), stepwise's path of cofactors
and selections equal and its min_p within 1e-5, on both meshes (each max |dp|
printed: the SNP-only mesh's is 0 where the cards round alike); and the
train step's top_f, top_idx, deltas and K bit-equal between the two
meshes, its K bit-equal to one card's integer gram.

  python3 scripts/torch_tp_nccl.py [--world 4] [--shape 2,2]
      [--samples 10240] [--snps 32768] [--device cuda|cpu]

Prints the card's name and power limit first and one JSON line of walls,
bytes and drifts last; exits non-zero when a rank fails or a check does.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TIERS = {"exact": False, "int8x3": "int8x3", "bf16x3": "bf16x3"}


def _genome(n: int, m: int, seed: int):
    """(m, n) int8 binary dosages of 3 populations and a trait on 10 of
    its first rows, the same on every rank."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, size=m)
    freqs = rng.beta(p * 9.0, (1.0 - p) * 9.0, size=(3, m))
    pop = rng.integers(0, 3, size=n)
    G = (rng.random((m, n), dtype=np.float32)
         < freqs[pop].T.astype(np.float32)).astype(np.int8)
    causal = rng.choice(min(m, 4_096), size=10, replace=False)
    g = G[causal].astype(np.float64)
    y = (rng.normal(size=10) @ (g - g.mean(1, keepdims=True))
         + rng.normal(size=n) * 2.0)
    return G, y


#: the entry points the 'sample' axis replicates, held within 1e-12 of one
#: card (a 'snp' shard's rows tile otherwise than one card's)
_REPLICATED = ("linear_model", "anova", "kruskal_wallis")


def _result_keys(ref):
    """(p-value keys, the statistic held for bit-equality, mask keys) of an
    entry point's result dict."""
    if "inter_ps" in ref and "marginal_ps" in ref:
        return (("marginal_ps", "inter_ps", "joint_ps"), "f_inter",
                ("mask", "mask_inter"))
    if "cond_ps" in ref:
        return ("cond_ps", "inter_ps"), "cond_ps", ()
    if "min_ps" in ref:
        return ("min_ps", "threshold"), "min_ps", ()
    if "stats" in ref:
        return ("ps",), "stats", ()
    return ("ps",), "f_stats", ("mask",) if "mask" in ref else ()


def _rank(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.emmax import emmax_anova
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    kinship_resident, scale_k)
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.scan import GXE_P_DRIFT, TIER_P_DRIFT
    from mixmogam_tpu_torch.parallel import (distributed_emmax,
                                             distributed_emmax_resident,
                                             distributed_kinship,
                                             distributed_train_step,
                                             initialize_multihost, make_mesh)
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    rank = int(os.environ["RANK"])
    cpu = args.device == "cpu"
    initialize_multihost(device="cpu" if cpu else None)
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    G, y = _genome(args.samples, args.snps, args.seed)
    eig = None
    if rank == 0:
        one = ResidentGenome.from_source(G, device=dev)
        K1 = kinship_resident(one)
        eig = eigen_k_on(scale_k(K1), dev)
    host = ResidentGenome.from_source(G, upload=False)
    rng = np.random.default_rng(args.seed + 1)
    Y = np.stack([y, y + rng.normal(size=y.size), rng.normal(size=y.size),
                  0.5 * y + rng.normal(size=y.size)])
    nl, ml = min(2_048, args.samples), min(8_192, args.snps)
    Gl, yl = np.ascontiguousarray(G[:ml, :nl]), y[:nl]
    chl = np.repeat([1, 2, 3], [ml // 4, ml // 2, ml - 3 * (ml // 4)])
    host_l = ResidentGenome.from_source(Gl, upload=False)
    # the remaining entry points on the first 8,192 rows: two environments
    # and a trait with an interaction on row 2, and diploid dosages (the
    # sum of two blocks of binary rows)
    ms = min(8_192, args.snps // 2)
    Gs, D = G[:ms], G[:ms] + G[ms:2 * ms]
    host_s = ResidentGenome.from_source(Gs, upload=False)
    env = np.column_stack([rng.normal(size=y.size),
                           (rng.random(y.size) < 0.5) * 1.0])
    y12 = y + 0.7 * G[2] * env[:, 0]
    shape = tuple(int(s) for s in args.shape.split(","))
    meshes = {"tp": make_mesh(shape, devices=args.device if cpu else None),
              "snp": make_mesh(devices=args.device if cpu else None)}
    walls, sent, res, refused = {}, {}, {}, {}

    def timed(name, fn):
        fn()                               # warm-up: communicators, caches
        dist.barrier()
        all_reduce.bytes = 0
        if not cpu:
            torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn()
        if not cpu:
            torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - ts, 3)
        sent[name] = all_reduce.bytes
        res[name] = out

    for key, mesh in meshes.items():
        timed(f"{key} distributed_kinship",
              lambda: distributed_kinship(G, mesh))
        for tier, rb in TIERS.items():
            timed(f"{key} distributed_emmax {tier}",
                  lambda: distributed_emmax(G, y, eig_k=eig, mesh=mesh,
                                            rotate_in_bf16=rb))
            timed(f"{key} distributed_emmax_resident {tier}",
                  lambda: distributed_emmax_resident(
                      host, y, eig_k=eig, mesh=mesh, rotate_in_bf16=rb))
        timed(f"{key} emmax_step_wise", lambda: emmax_step_wise(
            G, y, eig_k=eig, max_steps=3, mesh=mesh))
        for tier, src in (("exact", G), ("int8x3", host)):
            timed(f"{key} emmax_multi_trait {tier}",
                  lambda: emmax_multi_trait(src, Y, eig_k=eig,
                                            precision=tier, mesh=mesh))
        timed(f"{key} emmax_loco", lambda: emmax_loco(
            host_l, yl, chromosomes=chl, mesh=mesh))
        for tier, top in (("exact", 0), ("int8x3", 64)):
            timed(f"{key} emmax_gxe {tier}", lambda: emmax_gxe(
                Gs, y12, env, eig_k=eig, precision=tier, rescore_top=top,
                mesh=mesh))
        timed(f"{key} emmax_perm_test", lambda: emmax_perm_test(
            Gs, y, eig_k=eig, num_perm=128, mesh=mesh))
        timed(f"{key} emmax_two_snps", lambda: emmax_two_snps(
            Gs, y, eig_k=eig, focal_idx=[0, 1], mesh=mesh))
        for name, src in (("binary", Gs), ("diploid", D)):
            timed(f"{key} emmax_anova {name}", lambda: emmax_anova(
                src, y, eig_k=eig, mesh=mesh))
        for fn in (linear_model, anova, kruskal_wallis):
            timed(f"{key} {fn.__name__}", lambda: fn(Gs, y, mesh=mesh))
        timed(f"{key} distributed_train_step",
              lambda: distributed_train_step(mesh, G, Y, top_k=8))
        # 'high': multi-trait and GxE in core; the permutation test over a
        # host-only container, which a 'sample' axis refuses (in core it
        # takes no tier), as the JAX package does
        timed(f"{key} emmax_multi_trait high", lambda: emmax_multi_trait(
            G, Y, eig_k=eig, precision="high", mesh=mesh))
        timed(f"{key} emmax_gxe high", lambda: emmax_gxe(
            Gs, y12, env, eig_k=eig, precision="high", mesh=mesh))
        if mesh.shape[1] == 1:
            timed(f"{key} emmax_perm_test high", lambda: emmax_perm_test(
                host_s, y, eig_k=eig, num_perm=128, precision="high",
                mesh=mesh))
        else:
            try:
                emmax_perm_test(host_s, y, eig_k=eig, num_perm=128,
                                precision="high", mesh=mesh)
            except ValueError as e:
                refused[f"{key} emmax_perm_test high"] = str(e)
    if rank != 0:
        dist.barrier()
        dist.destroy_process_group()
        return
    checks, bad = {}, []
    for key in meshes:
        same = bool(np.array_equal(res[f"{key} distributed_kinship"], K1))
        checks[f"{key} distributed_kinship bit-equal"] = same
        bad += [] if same else [f"{key} kinship"]
    for tier in TIERS:
        ref = emmax_resident(one, y, eig_k=eig, precision=tier)
        tol = 1e-5 if tier == "exact" else TIER_P_DRIFT[tier]
        for key in meshes:
            for route in ("distributed_emmax", "distributed_emmax_resident"):
                got = res[f"{key} {route} {tier}"]
                nm = int((got["mask"] != ref["mask"]).sum())
                dp = float(np.abs(got["ps"] - ref["ps"]).max())
                checks[f"{key} {route} {tier}"] = {"masks_differ": nm,
                                                   "max_dp": dp}
                if nm or dp > tol:
                    bad.append(f"{key} {route} {tier}")
    refs = {"emmax_multi_trait exact": emmax_multi_trait(
                G, Y, eig_k=eig, device=dev),
            "emmax_multi_trait int8x3": emmax_multi_trait(
                one, Y, eig_k=eig, precision="int8x3"),
            "emmax_loco": emmax_loco(ResidentGenome.from_source(
                Gl, device=dev), yl, chromosomes=chl)}
    sw = emmax_step_wise(G, y, eig_k=eig, max_steps=3, device=dev)
    refs.update({
        "emmax_gxe exact": emmax_gxe(Gs, y12, env, eig_k=eig, device=dev),
        "emmax_gxe int8x3": emmax_gxe(Gs, y12, env, eig_k=eig,
                                      precision="int8x3", rescore_top=64,
                                      device=dev),
        "emmax_perm_test": emmax_perm_test(Gs, y, eig_k=eig, num_perm=128,
                                           device=dev),
        "emmax_two_snps": emmax_two_snps(Gs, y, eig_k=eig, focal_idx=[0, 1],
                                         device=dev),
        "emmax_anova binary": emmax_anova(Gs, y, eig_k=eig, device=dev),
        "emmax_anova diploid": emmax_anova(D, y, eig_k=eig, device=dev),
        **{fn.__name__: fn(Gs, y, device=dev)
           for fn in (linear_model, anova, kruskal_wallis)},
        "emmax_multi_trait high": emmax_multi_trait(
            G, Y, eig_k=eig, precision="high", device=dev),
        "emmax_gxe high": emmax_gxe(Gs, y12, env, eig_k=eig,
                                    precision="high", device=dev),
        "emmax_perm_test high": emmax_perm_test(
            ResidentGenome.from_source(Gs, device=dev), y, eig_k=eig,
            num_perm=128, precision="high")})
    for key in meshes:
        for name, ref in refs.items():
            if f"{key} {name}" in refused:
                msg = refused[f"{key} {name}"]
                checks[f"{key} {name}"] = {"refused": msg}
                if "shards 'snp' only" not in msg:
                    bad.append(f"{key} {name}")
                continue
            got = res[f"{key} {name}"]
            ps, stat, mask = _result_keys(ref)
            nm = int(sum((np.asarray(got[k]) != np.asarray(ref[k])).sum()
                         for k in mask))
            dp = max(float(np.abs(got[k] - ref[k]).max()) for k in ps)
            tol = (GXE_P_DRIFT["int8x3"] if name == "emmax_gxe int8x3"
                   else TIER_P_DRIFT["int8x3"] if "int8x3" in name
                   else TIER_P_DRIFT["bf16x3"] if name.endswith("high")
                   else 1e-12 if name in _REPLICATED else 1e-5)
            checks[f"{key} {name}"] = {
                "masks_differ": nm, "max_dp": dp,
                f"{stat}_bit_equal": bool(np.array_equal(got[stat],
                                                         ref[stat]))}
            if nm or dp > tol:
                bad.append(f"{key} {name}")
        got = res[f"{key} emmax_step_wise"]
        same = ([(s["cofactors"], s["min_p_snp"]) for s in got["steps"]]
                == [(s["cofactors"], s["min_p_snp"]) for s in sw["steps"]]
                and got["selected"] == sw["selected"])
        dp = max(abs(a["min_p"] - b["min_p"])
                 for a, b in zip(got["steps"], sw["steps"])
                 if np.isfinite(b["min_p"]))
        checks[f"{key} emmax_step_wise"] = {"same_path": same,
                                            "max_d_min_p": dp}
        if not same or dp > 1e-5:
            bad.append(f"{key} emmax_step_wise")
    # the train step: the same bits on both meshes, K one card's gram
    a, b = (res[f"{key} distributed_train_step"] for key in meshes)
    same = {k: bool(np.array_equal(a[k], b[k]))
            for k in ("top_f", "top_idx", "deltas", "K")}
    same["K is one card's gram"] = bool(np.array_equal(a["K"], K1))
    checks["distributed_train_step bit-equal"] = same
    if not all(same.values()):
        bad.append("distributed_train_step")
    print(json.dumps({"world": dist.get_world_size(), "shape": list(shape),
                      "n": args.samples, "M": args.snps, "walls_s": walls,
                      "reduced_bytes": sent, "checks": checks,
                      "failed": bad}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        raise SystemExit(f"disagrees with one device: {bad}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--shape", default="2,2")
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--snps", type=int, default=32_768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        _rank(args)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        from mixmogam_tpu_torch.ops import _build

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        _build.build_all(("ibs_gram", "ibs_gram_tri", "rotate_scan_int8",
                          "rotate_scan_bf16", "scan_stats"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(args.world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        if args.device == "cpu":
            env.update(OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank"]
            + sys.argv[1:], env=env))
    try:
        rcs = [p.wait(timeout=1_500) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
