#!/usr/bin/env python3
"""Reference optimum of a pose graph with the port: the centralized chordal
start, the host sparse LM polish (dpgo_tpu_torch/solvers/host_lm.py) and the
SE-Sync certificate (dpgo_tpu_torch/sesync/staircase.py::certify_solution,
the operator on the CUDA card unless --device names another).

    python tools/reference_optimum.py --dataset artifacts/rim_synth.g2o

Prints one JSON line: 2f of the LM solution (host float64), the
certificate's verdict, lambda_min, bound (2x) and route, and the seconds of
each stage. The rim cells' quality metric is the gap to this 2f.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min_eig_tol", type=float, default=1e-5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.sesync.staircase import certify_solution
    from dpgo_tpu_torch.solvers.host_lm import host_objective_2f, lm_polish

    meas = read_g2o_file(args.dataset)
    out = {"dataset": args.dataset, "poses": meas.num_poses,
           "edges": len(meas), "d": meas.d}
    t0 = time.perf_counter()
    R0 = chordal_initialization(meas)
    t_0 = recover_translations_global(meas, R0)
    out["chordal_s"] = time.perf_counter() - t0
    out["chordal_f2"] = host_objective_2f(meas, t_0, R0)
    t0 = time.perf_counter()
    res = lm_polish(meas, t_0, R0)
    out.update(lm_s=time.perf_counter() - t0, lm_iters=res.iters,
               lm_converged=res.converged, lm_grad_inf=res.grad_inf,
               f2=res.f2x)
    stats = {}
    ok, lam, bound, fx = certify_solution(meas, res.R,
                                          min_eig_tol=args.min_eig_tol,
                                          device=args.device, stats=stats)
    out.update(certified=bool(ok), lambda_min=lam, bound_2x=2 * bound,
               fxhat_2x=2 * fx, certify=stats)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
