"""The port's twins of the JAX package's top-level entry points
(__graft_entry__.py): entry(), the forward step of one scan tile, and
dryrun_multichip(), one distributed_train_step and every campaign entry
point on a mesh of ranks, each held to its single-device call.

    python -m mixmogam_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m mixmogam_tpu_torch.parallel.dryrun --world 4    # four cards

dryrun_rank(mesh) runs the checks on a mesh that already exists: every
rank of its group calls it. dryrun_multichip(world) spawns `world` ranks
(NCCL on the cards, one a rank; gloo in processes of one thread each
with device="cpu"), each joining the group through tcp://localhost and
calling dryrun_rank on the JAX dry run's mesh: (world / 2, 2) for an even
world above 2, else (world, 1). A failed check raises, on the rank and
then in the caller; none is caught.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

#: the line rank 0 prints last, which dryrun_multichip hands back
SUMMARY = "dryrun_multichip OK"


def entry(device=None):
    """(fn, example_args) of the tile forward step, the JAX package's
    entry(): fn(G_tile, rot) is the f_stats of ops/scan.py::
    emmax_scan_stats, the exact tier (an fp32 GEMM on the card, then kernel
    K3) on one tile of m = 256 binary rows, n = 128 samples and a design of
    q = 2 columns, drawn as the JAX entry draws them (its W = U * sd is
    here U, which K3 whitens by sd), in float32 on `device` (the card by
    default, raising without one; 'cpu' on request)."""
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.scan import RotatedNull, emmax_scan_stats

    device = resolve_device(device)
    n, q, m = 128, 2, 256
    rng = np.random.default_rng(0)
    phi = np.sort(rng.random(n) + 0.1)[::-1].copy()
    delta = 0.7
    sd = (1.0 / np.sqrt(phi + delta)).astype(np.float32)
    U = (rng.normal(size=(n, n)) / np.sqrt(n)).astype(np.float32)
    X0s = rng.normal(size=(n, q)).astype(np.float32)
    Q0, _ = np.linalg.qr(X0s)
    y = rng.normal(size=n).astype(np.float32)
    y_res = (y - Q0 @ (Q0.T @ y)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    rot = RotatedNull(sd=dev(sd), Q0=dev(Q0), y_res=dev(y_res),
                      rss0=dev(np.float32(y_res @ y_res)),
                      dof=dev(np.float32(n - q - 1)), U=dev(U))
    G_tile = dev((rng.random((m, n)) < 0.3).astype(np.float32))

    def fn(G_tile, rot):
        return emmax_scan_stats(G_tile, rot)[0]

    return fn, (G_tile, rot)


def mesh_shape(world: int):
    """The JAX dry run's mesh: dp over 'snp' and tp over 'sample' where the
    world divides evenly, (world / 2, 2) for an even world above 2, else
    (world, 1)."""
    return (world // 2, 2) if world % 2 == 0 and world > 2 else (world, 1)


def _data():
    """The JAX dry run's inputs, drawn alike on every rank: G (64, 32)
    float32 binary, Y (3, 32) heritable phenotypes (three causal rows), and
    the rng for the phases' draws."""
    rng = np.random.default_rng(0)
    n, M, T = 32, 64, 3
    G = (rng.random((M, n)) < 0.4).astype(np.float32)
    # heritable phenotypes, so the REML deltas land inside the grid (noise
    # alone may clamp to e^ulim, which would void the interior check)
    beta = np.zeros(M, dtype=np.float32)
    beta[[5, 21, 40]] = 1.0
    Y = (beta @ G + rng.normal(size=(T, n)) * 0.7).astype(np.float32)
    return G, Y, rng


def _max_dp(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def dryrun_rank(mesh, device=None) -> str:
    """The JAX dry run's phases on `mesh` (every rank of its group calls
    this), each mesh call held to its single-device call on this rank's
    device (default the mesh's), at the JAX dry run's limits or tighter:
    1. distributed_train_step (top_k 4): shapes, finite positive top_f,
       deltas strictly inside the REML grid; then on the (world, 1) mesh of
       the same ranks, top_idx, top_f, deltas and K bit-equal;
    2. distributed_emmax_resident on the (world, 1) mesh against
       emmax_resident, bit-equal p;
    3. on a 'sample' axis, distributed_emmax_resident on `mesh`, max |dp|
       below 1e-5;
    4. emmax_step_wise, 3 steps: the same cofactors, min_p within 1e-6;
    5. emmax_loco over 2 chromosomes, 6. emmax_gxe's interaction p, 7.
       emmax_perm_test's 16-permutation min p, 8. emmax_multi_trait with a
       missing phenotype block: each within 1e-6;
    9. emma on the (world, 1) mesh (it shards 'snp' alone) within 1e-3,
       the same best SNP.
    Returns the summary line (rank 0 prints it)."""
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident)
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.parallel.distributed import (
        distributed_emmax_resident, distributed_train_step)
    from mixmogam_tpu_torch.parallel.mesh import make_mesh

    device = mesh.device if device is None else torch.device(device)
    G, Y, rng = _data()
    M, n = G.shape
    T = Y.shape[0]
    out = distributed_train_step(mesh, G, Y, top_k=4, device=device)
    if (out["top_f"].shape != (T, 4) or out["top_idx"].shape != (T, 4)
            or out["K"].shape != (n, n) or out["deltas"].shape != (T,)):
        raise AssertionError("train step: malformed output")
    if not (np.all(np.isfinite(out["top_f"])) and np.all(out["top_f"] > 0)):
        raise AssertionError(f"train step: top-k F must be finite and "
                             f"positive: {out['top_f']}")
    d = out["deltas"]
    if not (np.all(np.isfinite(d)) and np.all(d > np.exp(-10.0) * (1 + 1e-6))
            and np.all(d < np.exp(10.0) * (1 - 1e-6))):
        raise AssertionError(f"train step: deltas clamp to the grid's "
                             f"ends: {d}")
    # mesh-shape invariance: the (world, 1) mesh of the same ranks
    mesh1 = make_mesh((mesh.world, 1), devices=device)
    out1 = distributed_train_step(mesh1, G, Y, top_k=4, device=device)
    for k in ("top_idx", "top_f", "deltas", "K"):
        if not np.array_equal(out[k], out1[k]):
            raise AssertionError(f"train step: {k} differs between meshes "
                                 f"{mesh.shape} and {mesh1.shape}")

    # the SNP-sharded resident scan: packed shards, replicated null. Each
    # pair below shares one eigh of K (eig_k): the mesh routes factor on
    # the host by default and one device's on the card, so K alone would
    # hold cuSOLVER to LAPACK rather than the sharded call to one device's
    Gi = (G > 0.5).astype(np.int8)
    rg = ResidentGenome.from_source(Gi, tile=16, device=device)
    Kr = np.asarray(out["K"], dtype=np.float64)
    eig = eigen_k_on(Kr, device)
    ref = emmax_resident(rg, Y[0], eig_k=eig)
    res = distributed_emmax_resident(rg, Y[0], eig_k=eig, mesh=mesh1,
                                     device=device)
    if not np.array_equal(res["ps"], ref["ps"]):
        raise AssertionError("sharded resident scan differs from the "
                             "single-device resident scan")
    deltas = {}
    if mesh.shape[1] > 1:
        # the 'sample' axis: a rank's rows x its byte block, the partial
        # rotations summed over 'sample'
        res = distributed_emmax_resident(rg, Y[0], eig_k=eig, mesh=mesh,
                                         device=device)
        deltas["resident_sample_tp"] = _max_dp(res["ps"], ref["ps"])
        if deltas["resident_sample_tp"] >= 1e-5:
            raise AssertionError(f"'sample' resident scan delta "
                                 f"{deltas['resident_sample_tp']}")

    y0 = np.asarray(Y[0], dtype=np.float64)
    sw_ref = emmax_step_wise(G, y0, eig_k=eig, max_steps=3, device=device)
    sw = emmax_step_wise(G, y0, eig_k=eig, max_steps=3, mesh=mesh,
                         device=device)
    if ([s["cofactors"] for s in sw["steps"]]
            != [s["cofactors"] for s in sw_ref["steps"]]):
        raise AssertionError("sharded stepwise selected other cofactors")
    deltas["stepwise_min_p"] = max(
        (abs(a["min_p"] - b["min_p"])
         for a, b in zip(sw["steps"], sw_ref["steps"])
         if np.isfinite(a.get("min_p", np.nan))), default=0.0)

    chroms = np.repeat([1, 2], M // 2)
    lc_ref = emmax_loco(rg, y0, chromosomes=chroms, ploidy=1)
    lc = emmax_loco(rg, y0, chromosomes=chroms, ploidy=1, mesh=mesh,
                    device=device)
    deltas["loco"] = _max_dp(lc["ps"], lc_ref["ps"])

    env = (rng.random(n) < 0.5).astype(np.float64)
    gx_ref = emmax_gxe(G, y0, env, eig_k=eig, device=device)
    gx = emmax_gxe(G, y0, env, eig_k=eig, mesh=mesh, device=device)
    deltas["gxe_inter"] = _max_dp(gx["inter_ps"], gx_ref["inter_ps"])

    pm_ref = emmax_perm_test(G, y0, eig_k=eig, num_perm=16, seed=5,
                             tile=16, device=device)
    pm = emmax_perm_test(G, y0, eig_k=eig, num_perm=16, seed=5, mesh=mesh,
                         device=device)
    deltas["perm_min_p"] = _max_dp(pm["min_ps"], pm_ref["min_ps"])

    Ym = np.asarray(Y, dtype=np.float64).copy()
    Ym[1, :5] = np.nan                    # two missingness groups
    # (a group's K is a sub-block: K, not eig_k; both sides factor alike)
    mt_ref = emmax_multi_trait(G, Ym, K=Kr, device=device)
    mt = emmax_multi_trait(G, Ym, K=Kr, mesh=mesh, device=device)
    deltas["multitrait"] = _max_dp(mt["ps"], mt_ref["ps"])
    for k in ("stepwise_min_p", "loco", "gxe_inter", "perm_min_p",
              "multitrait"):
        if deltas[k] >= 1e-6:
            raise AssertionError(f"{k}: the mesh call is {deltas[k]:.3e} "
                                 "from one device's")

    em_ref = emma(G, y0, eig_k=eig, tile=16, device=device)
    em = emma(G, y0, eig_k=eig, tile=16, mesh=mesh1, device=device)
    deltas["emma"] = _max_dp(em["ps"], em_ref["ps"])
    if deltas["emma"] >= 1e-3 or (int(np.argmin(em["ps"]))
                                  != int(np.argmin(em_ref["ps"]))):
        raise AssertionError(f"EMMA: the mesh call is {deltas['emma']:.3e} "
                             "from one device's")

    def shape(m):
        return {"snp": m.shape[0], "sample": m.shape[1]}

    phases = ", ".join(f"{k}={v:.2e}" for k, v in deltas.items())
    line = (f"{SUMMARY} on mesh {shape(mesh)} (+ mesh-invariance vs "
            f"{shape(mesh1)}; + sharded resident-packed scan bit-identical; "
            f"+ campaign phases [stepwise 3 fwd steps, LOCO 2 chrom, GxE, "
            f"16-perm sweep, multi-trait w/ missing-Y, EMMA exact] parity "
            f"deltas: {phases}): top_f per trait {out['top_f'][:, 0]}, "
            f"deltas {out['deltas']}")
    if mesh.rank == 0:
        print(line, flush=True)
    return line


#: seconds a rank of dryrun_multichip may take
_RANK_TIMEOUT = 900


def dryrun_multichip(world: int, device=None) -> str:
    """Spawn `world` ranks, each one process (NCCL on the cards, rank r on
    card r; gloo and one thread a process with device="cpu"), joined
    through tcp://localhost on a free port, each running dryrun_rank on
    the mesh of mesh_shape(world). Returns rank 0's summary line (printed
    here too); a rank that fails or outlasts _RANK_TIMEOUT seconds raises
    RuntimeError with the ranks' output."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"dryrun_multichip({world}) needs {world} cards, one a rank "
            f"(this machine has {torch.cuda.device_count()}); pass "
            'device="cpu" for gloo ranks on the host')
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if cpu:
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mixmogam_tpu_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(world), "--port", str(port)]
        + (["--device", "cpu"] if cpu else []), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_RANK_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outs += [""] * (world - len(outs))
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dryrun_multichip: a rank failed (rank, rc, "
                           "output): " + "; ".join(
                               f"{r}, {p.returncode}, {o[-3000:]}"
                               for r, (p, o) in enumerate(zip(procs, outs))))
    line = next(ln for ln in reversed(outs[0].splitlines())
                if ln.startswith(SUMMARY))
    print(line, flush=True)
    return line


def _rank_main(args) -> None:
    """One rank of dryrun_multichip: join the group, run dryrun_rank on
    the dry run's mesh, leave together."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.parallel.mesh import make_mesh
    from mixmogam_tpu_torch.parallel.multihost import initialize_multihost

    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(f"tcp://localhost:{args.port}", args.world,
                         args.rank, device=args.device)
    mesh = make_mesh(mesh_shape(args.world), devices=args.device)
    dryrun_rank(mesh)
    if dist.is_initialized():
        # no rank tears its group down while another still works
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the host (default: the "
                         "cards, one a rank)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
    else:
        dryrun_multichip(args.world, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
