"""Centralized certifiably-correct solver CLI (torch port of
dpgo_tpu/sesync_cli.py, the reference's `se_sync` example binary).

Usage:
    python -m dpgo_tpu_torch.sesync_cli --dataset path.g2o [--rmax 6]
        [--formulation simplified|sosync|explicit] [--lm] [--save]
        [--device cuda]

Runs on the CUDA card unless `--device` names another (`--device cpu`).
Returns the SESyncResult (of the staircase, or of the LM polish when --lm
improved it).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="SE-Sync on one CUDA card "
                                             "(PyTorch)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--rmax", type=int, default=6)
    ap.add_argument("--formulation", default="simplified",
                    choices=["simplified", "sosync", "explicit"])
    ap.add_argument("--min_eig_tol", type=float, default=1e-5)
    ap.add_argument("--lm", action="store_true",
                    help="finish with the host exact-Newton LM polish "
                         "(solvers/host_lm.py) and re-certify directly")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.sesync.staircase import SESyncOpts, sesync
    from dpgo_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    meas = read_g2o_file(args.dataset)
    print(f"dataset: {args.dataset}  poses={meas.num_poses}  "
          f"edges={len(meas)}  d={meas.d}")

    t0 = time.time()
    stats = {}
    res = sesync(meas, SESyncOpts(rmax=args.rmax,
                                  min_eig_tol=args.min_eig_tol),
                 formulation=args.formulation, device=device, stats=stats)
    dt = time.time() - t0
    print(f"status: {res.status}  (rank {res.rank}, {dt:.1f}s)")
    print(f"route: {stats['route']} (" + (
        "each rank's TNT one captured program" if stats["route"] == "graph"
        else "loop flags read on the host") + ")")
    print(f"SDP value (2x):     {2 * res.sdp_val:.12g}")
    print(f"rounded F (2x):     {2 * res.fxhat:.12g}")
    print(f"lambda_min(S):      {res.lambda_min:.6e}")
    print(f"suboptimality <=    {2 * res.suboptimality_bound:.6e}")

    if args.lm:
        from dpgo_tpu_torch.sesync.staircase import certify_solution
        from dpgo_tpu_torch.solvers.host_lm import lm_polish
        t0 = time.time()
        lmres = lm_polish(meas, res.t, res.R)
        ok, lam, bound, fx = certify_solution(
            meas, lmres.R, min_eig_tol=args.min_eig_tol, device=device)
        print(f"lm polish ({lmres.iters} it, {time.time() - t0:.1f}s): "
              f"2f = {2 * fx:.12g}  |g|_inf = {lmres.grad_inf:.2e}")
        print(f"direct certificate: "
              f"{'GLOBAL OPT' if ok else 'uncertified'}  "
              f"lambda_min={lam:.3e}  bound(2x)={2 * bound:.3e}")
        if 2 * fx < 2 * res.fxhat:
            res.t, res.R = lmres.t, lmres.R

    if args.save:
        t_n = (res.t - res.t[0]) @ res.R[0]
        R_n = np.einsum("ba,nbc->nac", res.R[0], res.R)
        with open("sesync_estimates.txt", "w") as fh:
            for p in range(meas.num_poses):
                fh.write(" ".join(f"{v:.16g}" for v in t_n[p]) + "\n")
            for p in range(meas.num_poses):
                for r in range(meas.d):
                    fh.write(" ".join(f"{v:.16g}" for v in R_n[p, r]) + "\n")
        print("wrote sesync_estimates.txt")
    return res


if __name__ == "__main__":
    main()
