"""Command-line driver: the reference dist_pgo equivalent (torch port of
dpgo_tpu/cli.py).

Usage:
    python -m dpgo_tpu_torch.cli --dataset path.g2o --num_nodes 4
        [--iters 1000] [--dist_init true] [--loss trivial|huber|...]
        [--accelerated true] [--solver hash|star] [--save true] [--f32]
        [--checkpoint path.npz] [--checkpoint_every 100] [--device cuda]
        [--polish OUTER] [--polish_tcg 500] [--polish_coarse true]
        [--polish_levels 64,256] [--lm_polish] [--certify]
        [--pcm] [--pcm_tolerance 0.2] [--pcm_stream BATCH]

Writes results_chordal_<N>_<amm|mm>.txt with rows `iter time fobj grad`
(2x-scaled objective/gradient as in the reference) and gauge-normalized
estimates_<loss>.txt (first pose at origin/identity) into the working
directory. Runs on the CUDA card unless `--device` names another
(`--device cpu`). `--pcm` rejects inconsistent inter-node loop closures
before the solve: PCM on the centralized chordal estimate, its loop errors
on the card in the solver's type, one-shot or streamed in batches
(`--pcm_stream`). After the MM iterations, `--polish`, `--lm_polish` and
`--certify` run in that order: the global Riemannian TNT polish on the card,
the host sparse LM polish, and the SE-Sync certificate of the final
rotations.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Distributed PGO on one CUDA "
                                             "card (PyTorch)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--num_nodes", type=int, required=True)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--dist_init", type=_bool, default=True)
    ap.add_argument("--loss", default="trivial",
                    choices=["trivial", "huber", "geman_mcclure", "welsch"])
    ap.add_argument("--loss_reg", type=float, default=0.25)
    ap.add_argument("--rescale", default="static",
                    choices=["static", "dynamic"],
                    help="robust-loss surrogate reweighting mode")
    ap.add_argument("--accelerated", type=_bool, default=True)
    ap.add_argument("--preconditioner", default=None,
                    choices=["none", "jacobi", "dense"],
                    help="STPCG preconditioner (default: dense on the "
                         "dense operator path, jacobi off it)")
    ap.add_argument("--accepted_delta", type=float, default=5e-4,
                    help="TNT refinement gate")
    ap.add_argument("--solver", default="hash", choices=["hash", "star"])
    ap.add_argument("--pcm", action="store_true",
                    help="PCM outlier rejection on inter edges before solving")
    ap.add_argument("--pcm_tolerance", type=float, default=0.2)
    ap.add_argument("--pcm_stream", type=int, default=0, metavar="BATCH",
                    help="feed inter edges through the incremental "
                         "PCMSolver pipeline in batches of BATCH; 0 = "
                         "one-shot")
    ap.add_argument("--save", type=_bool, default=True)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint_every", type=int, default=100)
    ap.add_argument("--record_every", type=int, default=1)
    ap.add_argument("--save_npz", default=None,
                    help="save the final estimate (t, R) to this .npz")
    ap.add_argument("--init_from", default=None,
                    help="warm-start from a saved .npz estimate instead of "
                         "the chordal initialization")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--certify", action="store_true",
                    help="SE-Sync certification of the final estimate")
    ap.add_argument("--polish", type=int, default=0, metavar="OUTER",
                    help="after the MM iterations, run OUTER global "
                         "Riemannian trust-region iterations on the coupled "
                         "problem (solvers/polish.py)")
    ap.add_argument("--polish_tcg", type=int, default=500)
    ap.add_argument("--polish_coarse", type=_bool, default=True,
                    help="two-level block-rigid coarse preconditioner for "
                         "the polish")
    ap.add_argument("--polish_levels", default="",
                    help="comma list of extra contiguous-segment coarse "
                         "levels for the polish preconditioner (e.g. "
                         "'64,256')")
    ap.add_argument("--lm_polish", action="store_true",
                    help="(trivial loss) finish with the host-side exact "
                         "sparse Newton polish (solvers/host_lm.py)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.losses import Loss
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    meas = read_g2o_file(args.dataset)
    loss = Loss(args.loss)
    # Validate flag combinations before the solve.
    if args.lm_polish and loss is not Loss.TRIVIAL:
        raise SystemExit("--lm_polish requires trivial loss")
    print(f"dataset: {args.dataset}  poses={meas.num_poses}  "
          f"edges={len(meas)}  d={meas.d}")

    if args.pcm:
        from dpgo_tpu_torch.pcm import (PCMOptions, pcm_filter,
                                        pcm_filter_incremental)
        from dpgo_tpu_torch.sesync import (chordal_initialization,
                                           recover_translations_global)
        R0 = chordal_initialization(meas)
        t0 = recover_translations_global(meas, R0)
        popts = PCMOptions(tolerance=args.pcm_tolerance)
        if args.pcm_stream > 0:
            meas, keep = pcm_filter_incremental(
                meas, args.num_nodes, t0, R0, popts, batch=args.pcm_stream,
                device=device, dtype=dtype)
        else:
            meas, keep = pcm_filter(meas, args.num_nodes, t0, R0, popts,
                                    device=device, dtype=dtype)
        print(f"PCM kept {keep.sum()}/{len(keep)} edges")

    opts = MMOptions(accelerated=args.accelerated, rescale=args.rescale,
                     preconditioner=args.preconditioner,
                     accepted_delta=args.accepted_delta)
    cls = DPGOStarSolver if args.solver == "star" else DPGOSolver
    solver = cls(meas, num_nodes=args.num_nodes, opts=opts, loss=loss,
                 loss_reg=args.loss_reg, dtype=dtype, device=device)

    if args.init_from:
        warm = np.load(args.init_from)
        st = solver.initialize(t=warm["t"], R=warm["R"])
    else:
        st = solver.initialize(dist_init=args.dist_init)
    start_iter = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        from dpgo_tpu_torch.checkpoint import load_state
        st, start_iter = load_state(args.checkpoint, st, solver=solver)
        print(f"resumed from {args.checkpoint} at iteration {start_iter}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    f, g = solver._metrics(st)
    rows = [(start_iter, 0.0, float(f), float(g))]
    print(f"{start_iter}: {float(f):.20g} {float(g):.20g}")

    elapsed = 0.0
    k = start_iter
    while k < args.iters:
        nxt = min(args.iters,
                  (k // args.record_every + 1) * args.record_every)
        if args.checkpoint:
            nxt = min(nxt, (k // args.checkpoint_every + 1)
                      * args.checkpoint_every)
        sync()
        t_start = time.perf_counter()
        st, _ = solver.run_steps(st, k, nxt - k)
        sync()
        elapsed += time.perf_counter() - t_start
        k = nxt
        if k % args.record_every == 0 or k == args.iters:
            f, g = solver._metrics(st)
            rows.append((k, elapsed, float(f), float(g)))
            print(f"{k}: {float(f):.20g} {float(g):.20g}")
        if args.checkpoint and k % args.checkpoint_every == 0:
            from dpgo_tpu_torch.checkpoint import save_state
            save_state(args.checkpoint, st, k, gauge_c=solver._c)

    if args.polish > 0:
        sync()
        t_start = time.perf_counter()
        segs = tuple(int(x) for x in args.polish_levels.split(",")
                     if x.strip())
        st, _ = solver.polish(st, outer=args.polish, tcg=args.polish_tcg,
                              coarse=args.polish_coarse,
                              coarse_segments=segs)
        sync()
        elapsed += time.perf_counter() - t_start
        f, g = solver._metrics(st)
        rows.append((k, elapsed, float(f), float(g)))
        print(f"polish({args.polish}): {float(f):.20g} {float(g):.20g}")

    if args.lm_polish:
        from dpgo_tpu_torch.solvers.host_lm import host_objective_2f, lm_polish
        t_g, R_g = (x.cpu().numpy().astype(np.float64)
                    for x in solver.gather_global(st))
        t_start = time.perf_counter()
        res = lm_polish(meas, t_g, R_g)
        elapsed += time.perf_counter() - t_start
        st = solver.initialize(res.t, res.R)
        f, g = solver._metrics(st)
        # A float32 solver's metrics have a ~1e-4-relative noise floor that
        # can mask the f64 polish; report the exact host f64 objective too.
        f64_2f = host_objective_2f(meas, res.t, res.R)
        rows.append((k, elapsed, float(f), float(g)))
        print(f"lm_polish({res.iters} it): {float(f):.20g} "
              f"{float(g):.20g} (exact f64 2f = {f64_2f:.12f})")

    print("---------------------------------------")
    print(f"final objective: {rows[-1][2]}")
    print(f"final gradient: {rows[-1][3]}")
    print(f"time: {elapsed / args.num_nodes} s/node.")

    t_glob, R_glob = (x.cpu().numpy().astype(np.float64)
                      for x in solver.gather_global(st))

    if args.save_npz:
        np.savez(args.save_npz, t=t_glob, R=R_glob)
        print(f"saved estimate to {args.save_npz}")

    if args.certify:
        from dpgo_tpu_torch.sesync.staircase import certify_solution
        ok, lam, bound, fx = certify_solution(meas, R_glob, device=device)
        print(f"certification: {'GLOBAL OPT' if ok else 'uncertified'} "
              f"lambda_min={lam:.3e} suboptimality_bound={bound:.3e}")

    if args.save:
        name = f"results_chordal_{args.num_nodes}_" \
               f"{'amm' if args.accelerated else 'mm'}.txt"
        with open(name, "w") as fh:
            for r in rows:
                fh.write(f"{int(r[0])} {r[1]:.16g} {r[2]:.16g} "
                         f"{r[3]:.16g}\n")
        # Gauge-normalize: first pose at origin / identity.
        t_n = (t_glob - t_glob[0]) @ R_glob[0]
        R_n = np.einsum("ba,nbc->nac", R_glob[0], R_glob)
        with open(f"estimates_{args.loss}.txt", "w") as fh:
            for p in range(meas.num_poses):
                fh.write(" ".join(f"{v:.16g}" for v in t_n[p]) + "\n")
            for p in range(meas.num_poses):
                for r in range(meas.d):
                    fh.write(" ".join(f"{v:.16g}"
                                      for v in R_n[p, r]) + "\n")
        print(f"wrote {name} and estimates_{args.loss}.txt")


if __name__ == "__main__":
    main()
