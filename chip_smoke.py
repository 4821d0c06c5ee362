#!/usr/bin/env python3
"""Smoke run of the dpgo_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dpgo_tpu_torch/csrc/` (nvcc, one
process per source, at first use), holds each against its plain PyTorch
version at the shapes of the paths below (K2 in float32 and float64; K3,
the d x d block products, in every form at rim's edge and pose batches,
timed beside the torch product), then
drives these paths once each through the public entry points, the refined
TNT preset, 16 nodes, float32, 150 iterations:

Every path through DPGOSolver / DPGOStarSolver takes the graph route: the
step captured once as a CUDA graph (its branches IF nodes and its bounded
loops WHILE nodes, through the flag kernel `csrc/graph_cond.cu`, held
against the host-read branch and loop in its own phase) and replayed per
iteration, 0 host syncs per step held; launches, loop trips and master
fallbacks are read from the device counters the step bumps. rim,
manhattan, star and rim100k_prox run again on the host-read route in the
same process (`run_steps_eager`, the plain version of the control flow):
2f held within 1e-3 of the graph route's and of the exact oracle, it/s,
host syncs, busy share and K1 / K2 launches per step printed for both,
with the capture's seconds and pool memory. Each phase prints its
seconds, and the end the whole run's.

1. rim: `artifacts/rim_synth.g2o` (10,240 poses, 640 per node, d = 3),
   AMM-PGO#, trivial loss. Kernels K1 (D = 3) and K2.
2. manhattan: a 2-D Manhattan-world graph of the city10000 family built
   from SEED + 1 (10,000 poses, 625 per node, d = 2), written as EDGE_SE2
   text and read back through the port's g2o reader. Kernel K1 (D = 2); the
   SO(2) projection is closed form.
3. robust: rim_synth with every tenth inter-node edge replaced by an
   outlier (drawn from SEED + 2), Huber loss (loss_reg 0.25) with dynamic
   rescale. K1 (D = 3, on the reweighted Hred) and K2.
4. star: rim_synth through DPGOStarSolver (AMM-PGO*) from the centralized
   chordal start of rim; host syncs and master fallbacks per step, final
   2f beside rim's. K1 and K2.
5. mm_dchordal: rim_synth through MM-PGO (accelerated=False) started from
   initialize(dist_init=True), the CLI's default DChordal start, whose
   stages run as one captured program (stage 0's TNT and CG and the four
   Nesterov stages as WHILE nodes). DChordal's stages run from one
   set-up per type (its parts timed) on the graph route with the kernels
   and with their plain versions and on the host-read route: in float64
   graph vs host-read held within 1e-8 and K2 vs plain within 1e-4 in 2f,
   0 host syncs, conditional nodes and K2 launched in the program, SO(3)
   within 1e-12; in float32 the solver's own start (graph route, K2,
   SO(3) within 1e-4). After every timed run, with the other profiles,
   the float32 stages run from a profiled set-up on the three routes
   (busy shares of the stages and of the whole); the float32 gaps are
   reported. Its 2f is reported
   beside 1.5 x the centralized chordal 2f + 1. MM's 2f never rises by
   more than 1e-5 of itself. K1 and K2.
6. the CLI (`dpgo_tpu_torch.cli.main`) in a temporary directory: AMM-PGO*
   with the DChordal start in float32 on the manhattan graph's .g2o file
   (30 iterations; K1 at D = 2), and the float64 default on
   `artifacts/grid3D_synth.g2o` with 4 nodes (20 iterations; K2's float64
   instantiation).
7. node blocks above the dense limit, float32, at the package's default
   limits (dense_limit 4096, segment_limit 2048, seg_size 128). K2 only:
   K1 is built for dense blocks.
   - rim100k_prox: `artifacts/rim_synth_100k.g2o` (102,400 poses, 6,400
     per node, made by `tools/make_rim.py --rows 32 --cols 64 --floors 50`
     in a subprocess when the file is absent), AMM-PGO# with the refinement
     off, 100 steps: the segment path's CG translation solves.
   - rim100k_refined: the same solver under the refined preset, 50 steps:
     the coupled (t, R) TNT model.
   - rim100k_robust: the graph with every tenth inter-node edge replaced by
     an outlier (SEED + 5), Huber + dynamic rescale, 40 steps: the CG
     matvec reads the rescale weights.
   - rim_edgewise: rim_synth with 6 nodes (1,707 poses per node,
     n0 d = 5,121), refined preset, 100 steps: the matrix-free operators
     and the R-space TNT model with the block-Jacobi preconditioner.
   - polish_rim100k: the global polish (3 outer iterations, STPCG capped at
     100, no coarse level) of rim100k_prox's state after its 100 steps: the
     segment branch of the node-block preconditioner and K2 at
     [102400, 3, 3]; 2f held not above the JAX bench's 167909.09. Its TNT
     runs as one captured program (graph route); the same polish on the
     host-read route follows (`polish(eager=True)`): 2f held within 1e-5
     relative, seconds, iterations, host syncs, pool and peak memory
     printed for both.
   On the rim100k solver two choices the package made are measured again:
   the block form of `mG00_matvec` against the edge-wise form, and the
   host-read CG loop against a fixed-trip loop that reads nothing (both
   alternatives are defined here, held to the package's results, and timed
   in turns).

8. the global polish and the certificate (run after path 6, before 7):
   - polish_rim: a float64 DPGOSolver on rim_synth with the refinement off,
     started from path 1's float32 estimate after its 150 steps, runs
     `polish(outer=10, tcg=300, coarse=True)` (K2 in float64 in every
     retraction), its TNT captured as one program (outer loop and STPCG
     WHILE nodes) and replayed once, no host sync in it (held); 2f held
     within 1e-8 of the certified optimum RIM_CERTIFIED_2F, 2|grad| to
     fall 100x, the same polish on the host-read route
     (`polish(eager=True)`) and with K2's plain version to agree within
     1e-10 in 2f; seconds, iterations and host syncs of both routes.
   - certify_rim: `certify_solution` on the card for the polished rotations
     (certified, lambda_min >= -1e-5, 2 fxhat within 1e-8 of the optimum)
     and for a negative control (rotations of poses 2000-3999 turned 0.5
     rad about z: not certified, lambda_min < -1e-2); prints the route,
     seconds on the card and on the host, and the host round trips.
   - cli_certify: `cli.main` on grid3D_synth, 4 nodes, float64, 20
     iterations, `--polish 5 --lm_polish --certify`: GLOBAL OPT, final 2f
     within 1e-9 of GRID3D_CERTIFIED_2F, result files written.
   - sesync_grid: `sesync_cli.main` on grid3D_synth: GlobalOpt at rank 3,
     2 SDP within 1e-8 of GRID3D_SDP_2F; then `sesync` on the graph route
     (each rank's TNT one captured program) and on the host-read route
     (`graph=False`) side by side (sesync_routes): the same status and
     rank, 2 SDP within 1e-10, 0 host syncs in the captured TNTs, K2
     float64 launched.
   - sesync_rim4096 (after path 8): rim_synth_4096 (4,096 poses, made by
     `tools/make_rim.py --rows 32 --cols 64 --floors 2` in a subprocess
     when absent, git-ignored), SE-Sync at its dense limit: `sesync` on
     both routes as sesync_grid (GlobalOpt held); then
     `certify_solution(method="lobpcg")` on its estimate and on a rotated
     control (poses 1000-1999 turned 0.5 rad) with the LOBPCG captured
     (ops/linalg.py: Gram-Schmidt basis, Jacobi Rayleigh-Ritz) and on
     the host-read route: estimate certified and control rejected on
     both, lambda_min within 1e-5 between them, 0 host syncs in the
     captured LOBPCG; the Chebyshev
     preconditioner where the plain LOBPCG does not resolve the sign
     within its budget (the choice printed). K2 float64 at [4096, 3, 3]
     is held to its plain version and timed among the kernel phases.

9. PCM and Anderson acceleration (run after path 6, before 8):
   - pcm_rim: rim_synth with every tenth inter-node edge an outlier (53,
     drawn from SEED), the centralized chordal start of that graph, then
     `pcm_filter` and `pcm_filter_incremental(batch=5)` with their loop
     errors on the card in float64 at tolerance 3.0 and at the CLI's 0.2:
     each keep mask held equal to the same call on the CPU, the cliques
     held to the native C++ route (built from `native/` into the port's
     build directory), no outlier kept by the batch filter at 3.0 (the JAX
     package on a CPU keeps 0 of 53 and drops 143 of 474 inliers). Then
     the filtered graph through AMM-PGO#, refined preset, trivial loss,
     150 steps (K1 and K2), its estimate's 2f on the clean rim graph
     printed beside the rim path's and RIM_CERTIFIED_2F, and the rim
     path's estimate scored on the filtered graph.
   - aa_rim: rim_synth through `MMOptions(scheme="aa")` (Anderson
     acceleration, defaults), 150 steps: K2 only; 2f never rises by more
     than 1e-5 of itself (the monotone safeguard).
   - cli_pcm: `cli.main` on the corrupted graph written to a temporary
     .g2o, `--num_nodes 16 --pcm --pcm_tolerance 3.0 --pcm_stream 5 --f32
     --iters 30` (DChordal start): its "PCM kept" line held to the count
     the streamed filter gives on the read-back graph, the result files
     written.

10. the sharded solvers (`dpgo_tpu_torch/parallel/`, run last), each rank
   a process of its own started by `parallel.launch.spawn` after the
   kernels are built here, on rim_synth (16 nodes, dense path, refined
   preset, float32, from rim's chordal start):
   - nccl1: over NCCL at world size 1 on cuda:0, on the graph route (the
     step captured with its NCCL collectives, 0 host syncs per step held;
     the program four ranks run, NCCL_GRAPH_MIXING_SUPPORT=0 as
     parallel/launch.py sets it): first probe_nccl_conditional (an
     all_reduce and an all_gather inside IF and WHILE bodies, held equal
     to eager); `ShardedDPGOSolver`, halo
     "boundary", 150 steps, and `ShardedDPGOStarSolver`, 50 steps (its
     master fallbacks' collectives inside IF bodies), each also on the
     host-read route in the same rank (2f within 1e-3 of the graph
     route's at every step; K1 / K2 launches and collectives per step,
     from device counters, within 0.1 per step, collectives equal where
     the fallbacks are);
   - gloo4: four ranks on cuda:0 over gloo (halos staged through the host):
     AMM-PGO# with "boundary", 150 steps; 20 steps each of "boundary"
     twice, "gather" and "ring", once in the default mode and once under
     torch.use_deterministic_algorithms, where the strategies must part
     from the first boundary run no more than the second one does;
     `ShardedDPGOStarSolver`, 50 steps; rim100k_prox's configuration
     (segment path, 4 x 4 nodes, refinement off), 25 steps;
   - nccl4: four ranks over NCCL on four cards, only where the machine has
     them.
   The polish with the pose axis split over the ranks (each rank its own
   poses, edges and problems; per CG iteration one halo exchange of the
   direction and all_reduces of scalars):
   - polish_rim, in nccl1 and gloo4: a float64 sharded solver on rim_synth
     (refinement off) from rim's float32 estimate, `polish(outer=10,
     tcg=300, coarse=True)` as path 8's polish_rim: 2f held within 1e-9 of
     that path's in the same call and within 1e-8 of RIM_CERTIFIED_2F;
     in nccl1 the TNT is one captured program with its NCCL collectives
     inside (0 host syncs held) and the same polish runs on the host-read
     route in the same rank: 2f within 1e-10 of it, exchanges and
     collectives per CG iteration within 0.1 of its;
   - polish_rim100k, in gloo4: `polish(outer=3, tcg=100, coarse=False)` in
     float32 of the state rim100k_prox's sharded run reaches after its 25
     steps (4 x 4 nodes, the segment branch of the node-block
     preconditioner): 2f held not above that state's and within 1e-5
     relative of the single-process polish of that same state (the ranks'
     own start rows joined, polished here on rim100k_prox's solver), a
     segment-Schwarz CG solve on every rank.
   Each holds 2f equal and finite on every rank, K2 launched on every rank
   and every rank's problems its own nodes' only, and prints per rank the
   seconds, outer and CG iterations, host syncs, collectives, bytes and
   host copies per CG iteration, K2 launches and the peak of
   torch.cuda.max_memory_allocated during the polish beside the
   single-process polish's in the same call.
   Every run's 2f history is held to the single-process run's (rim, star,
   rim100k_prox) within 1e-3 at every step; every rank reports the same
   history and master fallbacks and launches K2 (and K1 on rim). Each run
   prints it/s per rank, collectives, bytes and host copies per step per
   rank, K1 and K2 launches per rank and the backend. The runs of 150, 50
   and 25 steps are timed as paths 1-5 are, in a second run without
   history (its host syncs per step printed); nccl1 adds a profile of
   rim's window (steps 70-90).

Paths 1-5, 7 and pcm_rim / aa_rim are checked against the same path run
with the kernels' plain versions on the card, and against the exact global
objective.

Each K1 phase holds the kernel against its plain version at every cluster
size the card admits for the phase's shape (C CTAs per node, C in 1, 2, 4,
8), and times it at the size the wrapper chooses: the kernel alone on the
device (raw launches replayed from a CUDA graph, at every admitted size),
the call with its wrapper (CUDA events), the plain version, the bytes it
streams and its bound, and one torch.bmm over the operators as the
yardstick of one matvec. K2 likewise. After every timed run, each path is
profiled over steps 70-90 of a fresh run with torch.profiler (device ms per
step, busy share, top kernels).

Output: the card's name and power limit (nvidia-smi), one line per phase
(every time beside the card's name and power limit), a JSON line
{"paths": {...}}, a JSON line {"kernels": [...]}, and last a JSON line
{"ok": true, "device": {...}}. Any failed check raises, exits non-zero and
prints no result. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# torch.profiler tears CUPTI down at the end of a session and sets it up
# again at the next one; with CUDA graphs captured and replayed in between,
# that re-init can kill the process with a segmentation fault under CUDA 12.
# torch sets these two itself only for torch.compile's CUDA graphs; the port
# captures its own. Set before torch is imported, and inherited by the
# spawned ranks.
os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")

ITERS = 150
PROFILE_AT = 70  # the profiled window: steps 70-90 of a fresh run
PROFILE_STEPS = 20
NUM_NODES = 16
SEED = 0
DATASET = os.path.join("artifacts", "rim_synth.g2o")
RIM100K = os.path.join("artifacts", "rim_synth_100k.g2o")
# SE-Sync at its dense limit (sesync_rim4096): 2 floors of rim_synth's
# 32 x 64 sweep, 4,096 poses, the most that sesync/problem.py keeps the
# reduced Laplacian's inverse for on the card (above it every application
# of S is a host SuperLU round trip).
RIM4096 = os.path.join("artifacts", "rim_synth_4096.g2o")
# 2f after 100 proximal-only steps on rim_synth_100k with 16 nodes as the
# JAX package's bench recorded it (BENCH_r05.json, fobj_2x_100it): printed
# beside the port's, not held.
RIM100K_JAX_2F_100 = 167909.09
EDGEWISE_NODES = 6
LOSS_REG = 0.25  # the CLI's default robust-loss parameter
GRID3D = os.path.join("artifacts", "grid3D_synth.g2o")
# Certified optima (2f), made by the JAX package on a CPU in float64: the
# centralized chordal start, solvers/host_lm.py::lm_polish, then
# sesync/staircase.py::certify_solution (certified; rim: lambda_min
# -1.74e-9; grid3D: -5.0e-6). On grid3D_synth the staircase (sesync) reaches
# GlobalOpt at rank 3 with 2 SDP = GRID3D_SDP_2F.
RIM_CERTIFIED_2F = 16169.87454298
GRID3D_CERTIFIED_2F = 5385.488470979
GRID3D_SDP_2F = 5385.488470979148
# The global polish of the rim path's estimate (polish_rim): outer TNT
# iterations and the STPCG cap; on rim100k (polish_rim100k) a shorter run
# without the coarse level.
POLISH_OUTER, POLISH_TCG = 10, 300
POLISH_100K_OUTER, POLISH_100K_TCG = 3, 100
# Depth of rim100k_refined (100 steps until the polish paths came; cut
# with rim100k_robust's, 60 -> 40, and rim_edgewise's, 150 -> 100, to keep
# the whole run well inside its time limit).
REFINED_100K_STEPS = 50
# PCM on the outlier rim graph (pcm_rim, cli_pcm): tolerance and the
# incremental pipeline's batch.
PCM_TOL, PCM_BATCH = 3.0, 5
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, float32 and float64 outside the tensor cores (the kernels'
# types).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F64_FLOP_S = 34e12
# K2's float operations per matrix, counted from csrc/polar_so3.cu: the
# normalization and 9 Newton steps (a determinant, an adjugate, two norms
# and the scaled update, ~120 each); a det < 0 matrix adds ~200 for its flip.
K2_FLOPS = 1110
K2_FLIP_FLOPS = 200


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: check failed: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events, after a
    warm-up call)."""
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


def kernel_times(prof) -> dict:
    """{name: (device ms, launches)} of the CUDA activity a torch.profiler
    run recorded (kernels, copies and sets)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (us / 1e3, e.count)
    return out


def graph_ms(launch, reps: int) -> float:
    """Device milliseconds per launch: `reps` back-to-back calls of
    launch(stream), a raw launch of one kernel into preallocated outputs,
    captured in one CUDA graph and replayed (CUDA events, after a warm-up
    replay). The kernel alone, without its wrapper's host work; torch's
    profiler is kept out of this and of every timed run, since it is used
    only after them."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            launch(stream)
    return cuda_ms(graph.replay, 3) / reps


def bound(nbytes: float, flops: float, flop_s: float = F32_FLOP_S):
    """The least milliseconds the card could take: bytes over the HBM rate
    or operations over the peak rate of their type (float32 unless named),
    whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_graph_cond(rng, dev, card, nodes=64, reps=20):
    """The conditional-node kernel (csrc/graph_cond.cu: one thread hands a
    flag on the card to the graph's IF / WHILE node) against its plain
    version, the flag read on the host. A branch and a capped loop
    (utils.device_cond, utils.bounded_while) on 16 vectors drawn from
    `rng`: the captured graph replayed on each and the host-read route on
    each, held equal. Times: `ms` per IF node whose body is skipped (a
    graph of `nodes` of them, CUDA events), `plain_ms` per host read of a
    flag (bool() of a 0-d tensor on the card, host clock); the bound is
    the byte of the flag over the HBM rate."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import (bounded_while, device_cond, flatten,
                                      route)

    def step(v):
        y = device_cond(v.sum() > 0, lambda: 2.0 * v, lambda: v - 1.0)
        (z,) = bounded_while(
            64, lambda c: c[0] < 3.0,
            lambda c, run: (torch.where(run, c[0] + 0.5, c[0]),), (y,))
        return z

    inputs = [torch.tensor(rng.normal(size=32) * 3.0, dtype=torch.float32,
                           device=dev) for _ in range(16)]
    with route("host"):
        plain = [step(v) for v in inputs]
    graph_nodes.warm_streams(dev)
    static = inputs[0].clone()
    graph = torch.cuda.CUDAGraph()
    with graph_nodes.capture(graph, dev, torch.cuda.graph_pool_handle()) \
            as body_pool, route("capture"):
        out = step(static)
    err = 0.0
    for v, ref in zip(inputs, plain):
        static.copy_(v)
        graph.replay()
        err = max(err, float((out - ref).abs().max()))
    check(err == 0.0, f"graph_cond: the captured branch and loop differ "
          f"from the host-read route by {err}")

    skip = torch.zeros((), dtype=torch.bool, device=dev)
    many = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device=dev)
    with graph_nodes.capture(many, dev, torch.cuda.graph_pool_handle()) \
            as pool2:
        for _ in range(nodes):
            with graph_nodes.conditional(skip, graph_nodes.IF):
                x.add_(1.0)
    ms = cuda_ms(many.replay, reps) / nodes
    flag = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag)
    plain_ms = 1e3 * (time.perf_counter() - t0) / 200
    bnd, by = bound(1.0, 0.0)
    print(f"graph_cond [{card}]: captured branch + loop equal to the "
          f"host-read route on {len(inputs)} inputs (max abs err {err}); "
          f"{ms * 1e3:.2f} us per IF node with its flag kernel (body "
          f"skipped, {nodes} in one graph), host read of a flag "
          f"{plain_ms * 1e3:.2f} us; bound {bnd:.2e} ms ({by})")
    del body_pool, pool2
    return {"max_abs_err": err, "ms": ms, "device_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "shapes": {"branch_inputs": [32]}}


def phase_polar_so3(rng, dev, card, n=NUM_NODES * 640):
    """K2 against its plain version on n matrices (10,240: the rim paths'
    projection batch, 16 nodes x 640 poses; 102,400: the rim100k paths',
    16 x 6,400), every fifth with det < 0, plus one zero matrix."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3
    from dpgo_tpu_torch.synthetic import random_rotations

    # A = U diag(sigma) V^T with random rotations U, V and singular values
    # in [1, 1.5], [2, 2.5], [3.5, 4] times a scale in 1e-2..1e2; every fifth
    # negated (det < 0). The projection of a det < 0 matrix flips the
    # direction of its smallest singular value, which is ill-determined when
    # the two smallest singular values meet (the closest rotation is then
    # not unique), so the held inputs keep them apart; i.i.d. Gaussian
    # matrices are reported below but not held to 1e-5.
    sigma = np.array([1.0, 2.0, 3.5]) + rng.uniform(0, 0.5, size=(n, 3))
    sigma *= 10.0 ** rng.uniform(-2, 2, size=(n, 1))
    A = random_rotations(rng, n) @ (
        sigma[:, :, None] * random_rotations(rng, n).transpose(0, 2, 1))
    A[::5] *= -1.0
    A = np.concatenate([A, np.zeros((1, 3, 3))]).astype(np.float32)
    neg = np.linalg.det(A.astype(np.float64)) < 0
    At = torch.tensor(A, device=dev)
    R = polar_so3_cuda(At)
    Rp = polar_so3(At)
    torch.cuda.synchronize()
    err = float((R - Rp).abs().max())
    det_err = float((torch.linalg.det(R.double()) - 1.0).abs().max())
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    Rd = R.double()
    orth = float(torch.linalg.matrix_norm(Rd.transpose(-1, -2) @ Rd - eye)
                 .max())
    zero_ok = bool(torch.equal(R[-1], torch.eye(3, device=dev)))
    print(f"K2 polar_so3: {A.shape[0]} matrices ({int(neg.sum())} with "
          f"det < 0, 1 zero): max |kernel - plain| = {err:.3e}, "
          f"max |det - 1| = {det_err:.3e}, max |R^T R - I|_F = {orth:.3e}")
    check(err <= 1e-5, f"K2 max abs error {err} > 1e-5")
    check(det_err <= 1e-5, f"K2 det error {det_err} > 1e-5")
    check(orth <= 1e-5, f"K2 orthogonality error {orth} > 1e-5")
    check(zero_ok, "K2 zero matrix did not map to the identity")
    check(bool(torch.isfinite(R).all()), "K2 output not finite")

    Gauss = torch.tensor(rng.normal(size=(n, 3, 3)).astype(np.float32),
                         device=dev)
    g_diff = (polar_so3_cuda(Gauss) - polar_so3(Gauss)).abs().amax((1, 2))
    g_neg = torch.linalg.det(Gauss.double()) < 0
    print(f"K2 on i.i.d. Gaussian matrices (informational, ill-conditioned "
          f"cases included): max |kernel - plain| = "
          f"{float(g_diff[~g_neg].max()):.3e} (det > 0), "
          f"{float(g_diff[g_neg].max()):.3e} (det < 0)")

    At = At[:n].contiguous()
    ms = cuda_ms(lambda: polar_so3_cuda(At), 200)
    lib, out = _build.load(), torch.empty_like(At)
    dev_ms = graph_ms(lambda stream: _build.check(lib.dpgo_polar_so3(
        At.data_ptr(), out.data_ptr(), n, stream), "polar_so3"), 200)
    plain_ms = cuda_ms(lambda: polar_so3(At), 50)
    n_neg = int(neg[:n].sum())
    bnd, by = bound(2 * At.numel() * 4, n * K2_FLOPS + n_neg * K2_FLIP_FLOPS)
    print(f"K2 time at [{n}, 3, 3] [{card}]: device {dev_ms:.4f} ms, call "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library none; bound "
          f"{bnd:.5f} ms ({by}: {2 * At.numel() * 4} bytes), device time "
          f"at {bnd / dev_ms:.3f} of the bound")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None)


def phase_polar_so3_f64(rng, dev, card, n=NUM_NODES * 640):
    """K2's float64 instantiation (the CLI's default type) against its plain
    version on n matrices (10,240: the float64 rim polish's batch; 4,096:
    the rounding of sesync_rim4096) built as in phase_polar_so3, every
    fifth with det < 0, plus one zero matrix: within 1e-12, then timed."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.ops.polar_so3_cuda import polar_so3_cuda
    from dpgo_tpu_torch.ops.so3 import polar_so3
    from dpgo_tpu_torch.synthetic import random_rotations

    sigma = np.array([1.0, 2.0, 3.5]) + rng.uniform(0, 0.5, size=(n, 3))
    sigma *= 10.0 ** rng.uniform(-2, 2, size=(n, 1))
    A = random_rotations(rng, n) @ (
        sigma[:, :, None] * random_rotations(rng, n).transpose(0, 2, 1))
    A[::5] *= -1.0
    A = np.concatenate([A, np.zeros((1, 3, 3))])
    At = torch.tensor(A, dtype=torch.float64, device=dev)
    R = polar_so3_cuda(At)
    Rp = polar_so3(At)
    torch.cuda.synchronize()
    err = float((R - Rp).abs().max())
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    orth = float(torch.linalg.matrix_norm(R.transpose(-1, -2) @ R - eye)
                 .max())
    det_err = float((torch.linalg.det(R) - 1.0).abs().max())
    print(f"K2 polar_so3_f64: {A.shape[0]} float64 matrices "
          f"({int((np.linalg.det(A) < 0).sum())} with det < 0, 1 zero): max "
          f"|kernel - plain| = {err:.3e}, max |det - 1| = {det_err:.3e}, "
          f"max |R^T R - I|_F = {orth:.3e}")
    check(err <= 1e-12, f"K2 f64 max abs error {err} > 1e-12")
    check(orth <= 1e-12 and det_err <= 1e-12, "K2 f64 output not in SO(3)")
    check(bool(torch.equal(R[-1], eye)), "K2 f64 zero matrix did not map "
          "to the identity")

    At = At[:n].contiguous()
    ms = cuda_ms(lambda: polar_so3_cuda(At), 200)
    lib, out = _build.load(), torch.empty_like(At)
    dev_ms = graph_ms(lambda stream: _build.check(lib.dpgo_polar_so3_f64(
        At.data_ptr(), out.data_ptr(), n, stream), "polar_so3"), 200)
    plain_ms = cuda_ms(lambda: polar_so3(At), 50)
    n_neg = int((np.linalg.det(A[:n]) < 0).sum())
    nbytes = 2 * At.numel() * 8
    bnd, by = bound(nbytes, n * K2_FLOPS + n_neg * K2_FLIP_FLOPS, F64_FLOP_S)
    print(f"K2 f64 time at [{n}, 3, 3] [{card}]: device {dev_ms:.4f} ms, "
          f"call {ms:.4f} ms, plain {plain_ms:.4f} ms, library none; bound "
          f"{bnd:.5f} ms ({by}: {nbytes} bytes), device time at "
          f"{bnd / dev_ms:.3f} of the bound")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None)


# K3's batches at the rim paths' shapes: intra edges m0, inter edges m1 and
# poses n0 of the 16-node rim_synth problems, summed over the nodes.
K3_SHAPES = (24848, 14048, 10208)


def phase_block_mm(rng, dev, card):
    """K3 against its plain version (the torch product, cuBLAS on the card)
    and against float64 products on the host: every form (nn, nt and tn as
    transpose views, mv) at the rim paths' batches in float32 (within 2e-6
    of the blocks' unit scale, a 3-term FMA chain), d = 2 float32 and d = 3
    float64 (1e-14) at the largest; then timed at [24848, 3, 3] nn, the
    plain `@` as the library beside it. Returns the float32 nn entry with
    each timed form under "shapes"."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.ops import _build, block_mm_cuda

    lib = _build.load()
    cases = [(torch.float32, 3, n) for n in K3_SHAPES] + [
        (torch.float32, 2, K3_SHAPES[0]), (torch.float64, 3, K3_SHAPES[0])]
    err = 0.0
    for dtype, d, n in cases:
        A = torch.tensor(rng.normal(size=(n, d, d)), dtype=dtype, device=dev)
        B = torch.tensor(rng.normal(size=(n, d, d)), dtype=dtype, device=dev)
        v = torch.tensor(rng.normal(size=(n, d)), dtype=dtype, device=dev)
        tol = (2e-6 if dtype == torch.float32 else 1e-14) * d
        for form, out, plain, host in (
                ("nn", block_mm_cuda.block_mm(A, B), A @ B,
                 A.double().cpu() @ B.double().cpu()),
                ("nt", block_mm_cuda.block_mm(A, B.transpose(-1, -2)),
                 A @ B.transpose(-1, -2),
                 A.double().cpu() @ B.double().cpu().transpose(-1, -2)),
                ("tn", block_mm_cuda.block_mm(A.transpose(-1, -2), B),
                 A.transpose(-1, -2) @ B,
                 A.double().cpu().transpose(-1, -2) @ B.double().cpu()),
                ("mv", block_mm_cuda.block_mv(A, v),
                 (A @ v[..., None])[..., 0],
                 (A.double().cpu() @ v.double().cpu()[..., None])[..., 0])):
            e_plain = float((out - plain).abs().max())
            e_host = float((out.double().cpu() - host).abs().max())
            err = max(err, e_plain)
            check(e_host <= tol and e_plain <= 2 * tol,
                  f"K3 {form} d = {d} {dtype} n = {n}: |kernel - host f64| "
                  f"{e_host:.3e}, |kernel - plain| {e_plain:.3e} > {tol}")
        print(f"K3 block_mm d = {d} {str(dtype)[6:]} [{n}, {d}, {d}]: nn / "
              f"nt / tn / mv within {tol:.0e} of float64 host products; max "
              f"|kernel - plain| so far {err:.3e}")

    n, d = K3_SHAPES[0], 3
    A = torch.tensor(rng.normal(size=(n, d, d)), dtype=torch.float32,
                     device=dev)
    B = torch.tensor(rng.normal(size=(n, d, d)), dtype=torch.float32,
                     device=dev)
    v = B[:, :, 0].contiguous()
    out = torch.empty_like(A)

    def raw(X, Y, mv):
        Xs, Ys = X.stride(), Y.stride()
        return lambda stream: _build.check(lib.dpgo_block_mm(
            X.data_ptr(), Xs[0], Xs[1], Xs[2], Y.data_ptr(), Ys[0], Ys[1],
            Ys[2] if not mv else 0, out.data_ptr(), n, d, 0, int(mv), None,
            None, stream), "block_mm")

    shapes = {}
    for form, X, Y, mv in (("nn", A, B, False),
                           ("nt", A, B.transpose(-1, -2), False),
                           ("mv", A, v, True)):
        if mv:
            call, plain = (lambda: block_mm_cuda.block_mv(A, v),
                           lambda: (A @ v[..., None])[..., 0])
            nbytes = (n * d * d + 2 * n * d) * 4
        else:
            call, plain = (lambda: block_mm_cuda.block_mm(X, Y),
                           lambda: X @ Y)
            nbytes = 3 * n * d * d * 4
        dev_ms = graph_ms(raw(X, Y, mv), 200)
        ms = cuda_ms(call, 200)
        plain_ms = cuda_ms(plain, 200)
        lib_ms = graph_ms(lambda stream: plain(), 200)
        bnd, by = bound(nbytes, 2 * n * d * (d if not mv else 1) * d)
        shapes[f"{form} [{n}, 3, 3]"] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=lib_ms)
        print(f"K3 time {form} at [{n}, 3, 3] float32 [{card}]: device "
              f"{dev_ms:.4f} ms, call {ms:.4f} ms, plain (the torch product) "
              f"{plain_ms:.4f} ms, library device {lib_ms:.4f} ms; bound "
              f"{bnd:.5f} ms ({by}: {nbytes} bytes), device time at "
              f"{bnd / dev_ms:.3f} of the bound")
    return dict(shapes[f"nn [{n}, 3, 3]"], shapes=shapes)


def k1_work(k, nrm, Delta, nd: int, d: int):
    """What one K1 launch did on this data: (operator bytes streamed, bytes
    of the bound, float operations). Per node, k matvecs with Hred and k - 1
    with P after a boundary or kernel exit (|h|_M = Delta), else k. The
    bound reads each operator a node used once, the vectors g, v0, Q, S once
    and writes h, H h, |h|_M and k once."""
    k, nrm, Delta = k.tolist(), nrm.tolist(), Delta.tolist()
    op = nd * nd * 4
    n_h = list(k)
    n_p = [kk - (1 if kk and x == dl else 0)
           for kk, x, dl in zip(k, nrm, Delta)]
    streamed = (sum(n_h) + sum(n_p)) * op
    vec = nd * d * 4
    need = (sum(1 for x in n_h if x) + sum(1 for x in n_p if x)) * op \
        + len(k) * (6 * vec + 4 + 1 + 8)
    flops = (sum(n_h) + sum(n_p)) * 2 * nd * nd * d
    return streamed, need, flops


def k1_launch(args, Delta, active, kw, C):
    """launch(stream): one raw K1 launch in clusters of C on the operator
    and vector arguments `args`, into outputs allocated once here."""
    import torch

    from dpgo_tpu_torch.ops import _build
    lib = _build.load()
    g = args[2]
    N, nd, d = g.shape
    outs = (torch.empty_like(g), torch.empty_like(g),
            torch.empty(N, dtype=torch.float32, device=g.device),
            torch.empty(N, dtype=torch.int32, device=g.device))
    ptrs = [x.data_ptr() for x in (*args, Delta, active, *outs)]

    def launch(stream):
        _build.check(lib.dpgo_stpcg(*ptrs, N, nd, d, C, kw["max_iters"],
                                    kw["kappa_fgr"], kw["theta"], stream),
                     "stpcg")
    return launch


def phase_stpcg(label, p, st, tp, card, deltas=(1.0, 0.02, 100.0),
                timed=True):
    """K1 against its plain version on the problems `p` at the TNT-entry
    quantities of every node at state `st`, at every cluster size the card
    admits for this shape; node 0 is held to the tolerances of
    tests/test_pallas_stpcg.py and to the same CG count for each trust
    radius in `deltas`. The other nodes are reported: at a large radius a
    node whose CG runs many iterations may stop one iteration earlier or
    later in float32, where a residual meets the forcing target within
    rounding. Returns the errors, the largest CG count, the cluster sizes
    and, when `timed`, the times at Delta = 1 and 100 (device, call, plain,
    per cluster size), the work, the bound and the torch.bmm yardstick."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.ops.stpcg import stpcg_fused_reference
    from dpgo_tpu_torch.ops.stpcg_cuda import (CLUSTER_SIZES,
                                               choose_cluster_size,
                                               resident_clusters, stpcg_fused)
    from dpgo_tpu_torch.solvers.mm import stpcg_inputs

    check(p.fused_stpcg_supported(), f"{label}: K1 gate closed")
    args = stpcg_inputs(p, st)
    Q = args[4]
    N, nd, d = Q.shape
    dev = Q.device
    resident = resident_clusters(d, nd, dev)
    chosen = choose_cluster_size(N, nd // d, resident)
    sizes = [C for C in CLUSTER_SIZES if C <= nd // d and resident[C] > 0]
    print(f"K1 {label} (D = {d}, {N} nodes, nd = {nd}) [{card}]: resident "
          f"clusters by size {resident}, chosen C = {chosen}; held against "
          f"plain at C in {sizes}")
    kw = dict(max_iters=tp.max_tCG_iterations, kappa_fgr=tp.kappa_fgr,
              theta=tp.theta)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    max_err, k_max = 0.0, 0
    for Delta in deltas:
        Dl = torch.full((N,), Delta, dtype=torch.float32, device=dev)
        hr, Hhr, nrmr, kr = stpcg_fused_reference(*args, Dl, active, **kw)
        hr0 = hr[0].cpu().numpy()
        for C in sizes:
            h, Hh, nrm, k = stpcg_fused(*args, Dl, active, cluster=C, **kw)
            torch.cuda.synchronize()
            h0 = h[0].cpu().numpy()
            err = float(np.abs(h0 - hr0).max())
            max_err = max(max_err, err)
            k_all = bool((k == kr).all())
            k_max = max(k_max, int(k.max()))
            print(f"K1 stpcg {label} (D = {d}) Delta={Delta} C={C}: node 0 "
                  f"k = {int(k[0])} (plain {int(kr[0])}), max |h - h_plain| "
                  f"= {err:.3e}, |h|_M = {float(nrm[0]):.6g} (plain "
                  f"{float(nrmr[0]):.6g}); all {N} nodes: same k {k_all}, "
                  f"max |h - h_plain| = {float((h - hr).abs().max()):.3e}")
            if not k_all:
                print(f"K1 {label} Delta={Delta} C={C}: k per node "
                      f"{k.tolist()}, plain {kr.tolist()}")
            check(int(k[0]) == int(kr[0]),
                  f"K1 {label} C={C}: node 0 k {int(k[0])} != {int(kr[0])}")
            check(np.allclose(h0, hr0, rtol=2e-4, atol=2e-5),
                  f"K1 {label} C={C}: h outside rtol 2e-4 / atol 2e-5")
            check(np.allclose(Hh[0].cpu().numpy(), Hhr[0].cpu().numpy(),
                              rtol=2e-3, atol=2e-4),
                  f"K1 {label} C={C}: Hh outside rtol 2e-3 / atol 2e-4")
            check(abs(float(nrm[0]) - float(nrmr[0]))
                  <= 1e-4 * abs(float(nrmr[0])),
                  f"K1 {label} C={C}: |h|_M outside rtol 1e-4")
            check(bool(torch.isfinite(h).all()),
                  f"K1 {label} C={C}: output not finite")
    inactive = active.clone()
    inactive[0] = False
    Dl = torch.ones(N, dtype=torch.float32, device=dev)
    for C in sizes:
        h, _, _, k = stpcg_fused(*args, Dl, inactive, cluster=C, **kw)
        check(int(k[0]) == 0 and bool((h[0] == 0).all()),
              f"K1 {label} C={C}: inactive lane did not return a zero step "
              "with k = 0")
    out = dict(max_abs_err=max_err, k_max=k_max, cluster=chosen,
               resident=resident)
    if not timed:
        return out

    x = args[2]
    lib_ms = cuda_ms(lambda: torch.bmm(args[0], x), 50)
    print(f"K1 {label} [{card}]: torch.bmm(Hred, x) at [{N}, {nd}, {nd}] x "
          f"[{N}, {nd}, {d}], per matvec: {lib_ms:.4f} ms")
    out["library_ms"] = lib_ms
    for Delta in (1.0, 100.0):
        Dl = torch.full((N,), Delta, dtype=torch.float32, device=dev)
        _, _, nrm, k = stpcg_fused(*args, Dl, active, **kw)
        streamed, need, flops = k1_work(k, nrm, Dl, nd, d)
        bnd, by = bound(need, flops)
        ms = cuda_ms(lambda: stpcg_fused(*args, Dl, active, **kw), 20)
        dev_by_c = {C: graph_ms(k1_launch(args, Dl, active, kw, C), 20)
                    for C in sizes}
        plain = cuda_ms(lambda: stpcg_fused_reference(*args, Dl, active,
                                                      **kw), 20)
        dms = dev_by_c[chosen]
        tbs = streamed / (dms * 1e-3) / 1e12
        print(f"K1 time {label}, Delta = {Delta}, C = {chosen} [{card}]: k "
              f"per node {k.tolist()}; device {dms:.4f} ms, call {ms:.4f} "
              f"ms, plain {plain:.4f} ms; streamed {streamed / 1e6:.1f} MB "
              f"at {tbs:.3f} TB/s ({tbs * 1e12 / HBM_BYTES_S:.3f} of "
              f"3.35); bound {bnd:.4f} ms ({by}: {need / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP), device time at "
              f"{bnd / dms:.3f} of the bound; device ms by C "
              + ", ".join(f"{C}: {t:.4f}" for C, t in dev_by_c.items()))
        # The operators (16 x nd^2 floats) cannot stay on chip between CG
        # iterations, so each pass of a node's k streams its Hred and P
        # again: the bound of those passes, beside the read-once bound.
        bnd_k = 1e3 * streamed / HBM_BYTES_S
        print(f"K1 {label}, Delta = {Delta}: bound of the operator passes "
              f"(k per node x {nd * nd * 4 / 1e6:.2f} MB per operator pass) "
              f"{bnd_k:.4f} ms, device time at {bnd_k / dms:.3f} of it")
        tag = "" if Delta == 1.0 else "100"
        out.update({f"bound_passes_ms{tag}": bnd_k})
        out.update({f"ms{tag}": ms, f"device_ms{tag}": dms,
                    f"plain_ms{tag}": plain, f"bound_ms{tag}": bnd,
                    f"bound_by{tag}": by, f"streamed_bytes{tag}": streamed,
                    f"tb_s{tag}": tbs, f"k{tag}": k.tolist(),
                    f"device_ms_by_cluster{tag}": dev_by_c})
    return out


def profile_path(name, solver, init, card, at=PROFILE_AT,
                 steps=PROFILE_STEPS, eager=False):
    """Steps `at` to `at + steps` of a fresh run of one path under
    torch.profiler, after `steps` steps timed without it:
    device ms per step (all CUDA activity, the kernels inside graph replays
    included), its share of the unprofiled wall ms per step (the busy
    share), K1's and K2's device ms and launches per step, and the six
    largest kernels; printed and returned. On the graph route
    (`run_steps`), or with `eager` on the host-read route
    (`run_steps_eager`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run = solver.run_steps_eager if eager else solver.run_steps
    st, k = run(solver.initialize(*init), 0, at - steps)
    syncs0 = solver.syncs.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, k = run(st, k, steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    syncs = (solver.syncs.count - syncs0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(st, k, steps)
        torch.cuda.synchronize()
    kt = kernel_times(prof)
    total = sum(ms for ms, _ in kt.values()) / steps

    def of(name):
        hits = [v for key, v in kt.items() if name in key]
        return (sum(ms for ms, _ in hits) / steps,
                sum(n for _, n in hits) / steps)

    k1_ms, k1_n = of("stpcg_kernel")
    k2_ms, k2_n = of("polar_so3_kernel")
    top = sorted(kt.items(), key=lambda kv: -kv[1][0])[:6]
    prof = {"route": "eager" if eager else "graph",
            "steps": [at, at + steps], "device_ms_per_step": total,
            "wall_ms_per_step": wall_ms, "host_syncs_per_step": syncs,
            "busy_share": total / wall_ms, "k1_ms_per_step": k1_ms,
            "k1_launches_per_step": k1_n, "k2_ms_per_step": k2_ms,
            "k2_launches_per_step": k2_n,
            "top": [[key[:80], ms / steps, n / steps]
                    for key, (ms, n) in top]}
    print(f"{name} profile of steps {at}-{at + steps}, "
          f"{prof['route']} route [{card}]: device {total:.3f} ms/step of "
          f"{wall_ms:.3f} wall "
          f"(busy share {total / wall_ms:.3f}), {syncs:.2f} host syncs/step; "
          f"K1 {k1_ms:.3f} ms/step over "
          f"{k1_n:.2f} launches, K2 {k2_ms:.4f} ms/step over {k2_n:.2f}; "
          "top (ms/step, launches/step): "
          + "; ".join(f"{key} {ms:.3f} ({n:.1f})"
                      for key, ms, n in prof["top"]))
    return prof


DCHORDAL_LOOPS = ("dchordal.reduced_R", "dchordal.full_R",
                  "dchordal.reduced_t", "dchordal.full_t", "tnt", "stpcg")


def dchordal_routes(meas, dtype, dev, card, runs, f2, profile=False):
    """DChordal's stages from one set-up (`dchordal._setup`, timed by part)
    in `dtype`, once per (label, kernels, graph) of `runs`: the graph route
    (one captured program replayed once) or the host-read route, with K2
    or its plain version. Per run: 2f of the start (`f2`), the stages'
    seconds (graph: warm-up, capture, replay by CUDA events, pool MiB),
    host syncs, launches and conditional nodes and the stage loops' and
    stage 0's TNT / CG trips from the device counters, and the peak
    allocated MiB above the set-up. With `profile`, the set-up runs under
    torch.profiler (its device seconds and top kernels) and the first run
    gives the busy shares: the stages' (replay device seconds over the
    stages' wall seconds) and the whole run's (set-up device seconds plus
    the replay's, over set-up and stages' wall). Returns {"setup": ...,
    label: record (t, R included)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from dpgo_tpu_torch.chordal import dchordal
    from dpgo_tpu_torch.utils import DeviceCounters

    cfg = dchordal.DChordalConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            s = dchordal._setup(meas, NUM_NODES, cfg, dtype, dev)
            torch.cuda.synchronize()
    else:
        s = dchordal._setup(meas, NUM_NODES, cfg, dtype, dev)
        torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    out = {"setup": dict(s.seconds, total=time.perf_counter() - t0)}
    print(f"mm_dchordal: DChordal {name} set-up [{card}] "
          f"{out['setup']['total']:.2f} s: problem builds "
          f"{s.seconds['problems']:.2f}, per-node seeds "
          f"{s.seconds['seeds']:.2f}, rotation system and split inverse "
          f"{s.seconds['rotation_system']:.2f}, copies "
          f"{s.seconds['copies']:.3f}")
    if profile:
        kt = kernel_times(prof)
        top = sorted(kt.items(), key=lambda kv: -kv[1][0])[:4]
        out["setup"].update(device_s=sum(ms for ms, _ in kt.values()) / 1e3,
                            top=[[k[:80], ms] for k, (ms, _) in top])
    for label, kernels, graph in runs:
        reset_counts()
        p0 = peak_start(dev)
        stats = {}
        t, R = dchordal._run(s, kernels, graph, stats)
        rec = dict(stats, t=t, R=R, f2=f2(t, R),
                   launches=kernel_counts(),
                   trips={n: [DeviceCounters.read(n + ".entries"),
                              DeviceCounters.read(n + ".trips")]
                          for n in DCHORDAL_LOOPS},
                   peak_mib=peak_read(dev, p0)["above"] / 2**20)
        out[label] = rec
        cap = (f"warm-up {rec['warmup_s']:.2f} s, capture "
               f"{rec['capture_s']:.2f} s, replay {rec['replay_s']:.3f} s, "
               f"pool {rec['pool_mib']:.1f} MiB, " if graph else "")
        print(f"mm_dchordal: DChordal {name} stages, {stats['route']} "
              f"route, {'K2' if kernels else 'plain'} [{card}]: "
              f"{rec['stages_s']:.2f} s ({cap}peak above set-up "
              f"{rec['peak_mib']:.1f} MiB); 2f {rec['f2']:.8f}; host syncs "
              f"{rec['host_syncs']}; launches {rec['launches']}; "
              f"loops [entries, trips] {rec['trips']}")
    if profile:
        first = out[runs[0][0]]
        setup = out["setup"]
        whole_s = setup["total"] + first["stages_s"]
        dev_s = setup["device_s"] + first["replay_s"]
        out["profile"] = {
            "route": first["route"], "whole_s": whole_s,
            "setup_s": setup["total"], "setup_device_s": setup["device_s"],
            "stages_s": first["stages_s"], "replay_s": first["replay_s"],
            "stages_busy_share": first["replay_s"] / first["stages_s"],
            "busy_share": dev_s / whole_s, "setup_top": setup["top"]}
        pr = out["profile"]
        print(f"DChordal profile, {pr['route']} route [{card}]: whole "
              f"{whole_s:.2f} s, device {dev_s:.3f} s (busy share "
              f"{pr['busy_share']:.4f}); set-up {setup['total']:.2f} s, "
              f"device {setup['device_s']:.3f} s (profiled); stages "
              f"{first['stages_s']:.2f} s, replay {first['replay_s']:.3f} s "
              "(CUDA events; busy share of the stages "
              f"{pr['stages_busy_share']:.4f}); set-up's top: "
              + "; ".join(f"{n} {ms:.1f} ms" for n, ms in setup["top"]))
    return out


def run_slice(solver, init, label, steps, runs=2):
    """initialize + `steps` steps with history, then a second, timed run of
    `steps` steps from the same start; with `runs=1` (the paths whose steps
    take a tenth of a second and more) the history run is the timed one.
    Returns (2f init, 2f history, 2f exact at the end, it/s, host syncs per
    step, final state)."""
    import numpy as np
    import torch

    st = solver.initialize(*init)
    f0, g0 = solver._metrics(st)
    # The graph route captures its step at the first call: made here on a
    # one-step run and timed apart (graph_stats), outside the timed runs;
    # that step's launches and fallbacks are not counted.
    from dpgo_tpu_torch.utils import DeviceCounters
    snap = DeviceCounters.snapshot()
    fired = {n: t.clone() for n, t in getattr(solver, "_fired", {}).items()}
    solver.run_steps(st, 0, 1)
    DeviceCounters.restore(snap)
    for n, t in fired.items():
        solver._fired[n].copy_(t)
    torch.cuda.synchronize()
    syncs0 = solver.syncs.count
    t0 = time.perf_counter()
    st, _, (fh, gh) = solver.run_steps_history(st, 0, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = (solver.syncs.count - syncs0) / steps
    f_end, g_end = solver._metrics(st)
    fh = fh.cpu().numpy()
    gh = gh.cpu().numpy()
    check(fh.shape == (steps,) and gh.shape == (steps,),
          f"{label}: history shape {fh.shape}")
    check(bool(np.isfinite(fh).all() and np.isfinite(gh).all()),
          f"{label}: non-finite history")
    for name, x in (("Z.t", st.Z.t), ("Z.R", st.Z.R)):
        check(bool(torch.isfinite(x).all()), f"{label}: non-finite {name}")
    if runs == 1:
        return float(f0), fh, float(f_end), steps / secs, syncs, st

    st2 = solver.initialize(*init)
    torch.cuda.synchronize()
    syncs0 = solver.syncs.count
    t0 = time.perf_counter()
    st2, _ = solver.run_steps(st2, 0, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = (solver.syncs.count - syncs0) / steps
    return float(f0), fh, float(f_end), steps / secs, syncs, st


KERNEL_NAMES = ("polar_so3", "polar_so3_f64", "stpcg", "stpcg_d2",
                "block_mm", "graph_cond")
# The loops whose entries and trips the step counts on the device.
DEVICE_LOOPS = ("tnt", "stpcg", "seg_cg")


def kernel_counts():
    """Launches per kernel since the last reset, from the device counters
    each wrapper bumps where it launches its kernel (inside a captured
    step too, at every replay); reading them waits for the card."""
    from dpgo_tpu_torch.utils import DeviceCounters
    return {n: DeviceCounters.read(n) for n in KERNEL_NAMES}


def reset_counts():
    from dpgo_tpu_torch.ops import block_mm_cuda, polar_so3_cuda, stpcg_cuda
    from dpgo_tpu_torch.utils import DeviceCounters
    polar_so3_cuda.Launches.reset()
    stpcg_cuda.Launches.reset()
    block_mm_cuda.Launches.reset()
    DeviceCounters.reset()


def device_loop_stats() -> dict:
    """Trips per entry of the step's bounded loops since the last reset,
    from the device counters: {name: [entries, trips per entry]}."""
    from dpgo_tpu_torch.utils import DeviceCounters
    out = {}
    for name in DEVICE_LOOPS:
        n = DeviceCounters.read(name + ".entries")
        if n:
            out[name] = [n, DeviceCounters.read(name + ".trips") / n]
    return out


def peak_start(device) -> int:
    """Wait for the card, restart its peak-memory count; the bytes
    allocated now."""
    import torch
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def peak_read(device, start: int) -> dict:
    """This process's peak of allocated bytes since peak_start, and how
    far it rose above the bytes allocated then."""
    import torch
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {"peak": peak, "above": peak - start}


def problem_bytes(probs) -> int:
    """Bytes of a NodeProblem's tensors."""
    import torch
    return sum(v.numel() * v.element_size() for v in vars(probs).values()
               if isinstance(v, torch.Tensor))


def run_path(name, solver, init, needs, card, steps=ITERS, reset=True,
             monotone=False, fused=True, runs=2):
    """Drive one path through the kernels (launch counts reset just before,
    unless the caller did so before its own part of the path, and read just
    after), then through the plain versions on the same problems; check
    decrease, the global oracle, kernel-vs-plain agreement and that every
    kernel in `needs` was launched; with `monotone`, that 2f never rose by
    more than 1e-5 of itself from one step to the next. `fused` says whether
    the path's TNT subproblem runs in kernel K1 (the dense paths): the
    solver must report the same, and a path off the dense images must not
    launch K1. `runs`: see run_slice. Returns (summary dict, launches, final
    state of the kernel run)."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.utils import HostSyncs

    check(solver.fused_stpcg_engaged() == fused, f"{name}: "
          f"fused_stpcg_engaged() is {not fused}")
    solver.syncs = HostSyncs()
    star = hasattr(solver, "reset_fallbacks")
    if star:
        solver.reset_fallbacks()
    if reset:
        reset_counts()
    f0, fh, f_exact, its, syncs, st = run_slice(solver, init, name, steps,
                                                runs)
    launches = kernel_counts()
    fallbacks = solver.fallbacks if star else None
    graph = solver.graph_stats()
    check(graph is not None, f"{name}: the step was not captured")
    print(f"{name}: graph route, step captured in {graph['capture_s']:.2f} s "
          f"after a {graph['warmup_s']:.2f} s warm-up step; its pools hold "
          f"{graph['pool_bytes'] / 2**20:.1f} MiB [{card}]")
    check(syncs == 0, f"{name}: {syncs} host syncs per step on the graph "
          "route")
    over = "two runs" if runs == 2 else "one run"
    print(f"{name} with kernels [{card}]: 2f init {f0:.6f}, 2f at {steps} "
          f"{fh[-1]:.6f} (exact oracle {f_exact:.6f}), {its:.2f} it/s, "
          f"{syncs:.2f} host syncs/step, launches {launches} over {over} "
          f"of {steps} steps")
    if fallbacks is not None:
        print(f"{name}: master fallbacks over {over} of {steps} steps "
              f"{fallbacks}")
    rise = float(np.max(np.diff(fh) / np.abs(fh[1:])))
    if monotone:
        print(f"{name}: largest 2f rise from one step to the next "
              f"{rise:.3e} of 2f")
        check(rise <= 1e-5, f"{name}: 2f rose by {rise} > 1e-5 of itself")
    for kern in needs:
        check(launches[kern] > 0, f"{name}: kernel {kern} was not launched: "
              f"{launches}")
    if not fused:
        check(launches["stpcg"] == launches["stpcg_d2"] == 0,
              f"{name}: K1 was launched off the dense path: {launches}")
    loops = device_loop_stats()
    if loops:
        print(f"{name}: bounded loops on the device, [entries, trips per "
              f"entry] over {over} of {steps} steps: {loops}")
    check(fh[-1] < f0, f"{name}: 2f did not decrease: {fh[-1]} >= {f0}")
    check(abs(f_exact - fh[-1]) <= 1e-3 * abs(f_exact),
          f"{name}: node-objective sum {fh[-1]} disagrees with the global "
          f"oracle {f_exact}")

    # The same path with the kernels' plain versions, on the same problems.
    twin = copy.copy(solver)
    twin.probs = dataclasses.replace(solver.probs, kernels=False)
    twin.syncs = HostSyncs()
    if star:
        twin._fired = {n: torch.zeros_like(t)
                       for n, t in solver._fired.items()}
    before = kernel_counts()
    _, fhp, _, its_p, syncs_p, _ = run_slice(twin, init, f"{name} plain",
                                             steps, runs)
    after = kernel_counts()
    check(all(before[k] == after[k] for k in KERNEL_NAMES[:5]),
          f"{name}: the plain run launched a kernel")
    rel = abs(fh[-1] - fhp[-1]) / abs(fhp[-1])
    print(f"{name} with plain versions [{card}]: 2f at {steps} "
          f"{fhp[-1]:.6f}, "
          f"{its_p:.2f} it/s, {syncs_p:.2f} host syncs/step; kernel vs plain "
          f"2f relative difference {rel:.3e}")
    check(rel <= 1e-3, f"{name}: kernel and plain runs disagree: {rel} > "
          "1e-3")
    # Relative to the decrease so far. On manhattan the final 2f of a run
    # with the refinement off lies within 5e-3 of the decrease from the
    # kernel run's, as near as rounding puts two kernel runs, but at step 1
    # it lies 0.41 of the decrease away; rounding moves step 1 by up to
    # 2.6e-2 (index_add_ scatters are not deterministic on the card, and a
    # flipped branch on one node moves 2f).
    dec = abs(fh - fhp) / (f0 - fhp)
    print(f"{name}: kernel vs plain 2f difference relative to the decrease "
          f"so far: {dec[0]:.3e} at step 1, {dec[-1]:.3e} at step {steps}, "
          f"max {dec.max():.3e}")
    check(dec[0] <= 0.1, f"{name}: kernel and plain runs part at step 1: "
          f"{dec[0]} of the decrease > 0.1")
    del twin
    torch.cuda.synchronize()
    summary = {"steps": steps, "timed_runs": runs, "it_s": its,
               "plain_it_s": its_p,
               "f2_init": f0, "f2_final": float(fh[-1]),
               "f2_history": fh,
               "f2_final_plain": float(fhp[-1]), "f2_exact": f_exact,
               "f2_step1_vs_plain_of_decrease": float(dec[0]),
               "host_syncs_per_step": syncs,
               "plain_host_syncs_per_step": syncs_p, "launches": launches,
               "launches_per_step": {k: v / (runs * steps)
                                     for k, v in launches.items()},
               "graph": graph,
               "largest_rise_of_2f": rise, "loops": loops, "card": card}
    if fallbacks is not None:
        summary["fallbacks_per_step"] = {k: v / (runs * steps)
                                         for k, v in fallbacks.items()}
    return summary, launches, st


# The paths whose control flow runs on both routes in the same process:
# the graph route (run_path) and the host-read route (eager_route).
EAGER_PATHS = ("rim", "manhattan", "star", "rim100k_prox")


def eager_route(name, solver, init, card, summary, steps=None):
    """The path again on the host-read route (`run_steps_eager`, every
    loop and branch flag read on the host), the plain version of the graph
    route's control flow, from a fresh start: its 2f after the steps held
    within 1e-3 of the graph route's and of the exact oracle; it/s, host
    syncs and K1 / K2 launches per step beside the graph route's. Stored
    in summary["eager"]."""
    import torch

    from dpgo_tpu_torch.utils import HostSyncs
    steps = steps or summary["steps"]
    solver.syncs = HostSyncs()
    st = solver.initialize(*init)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = solver.run_steps_eager(st, 0, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_counts()
    f_end = 2.0 * float(st.fobj.sum())
    f_exact = float(solver._metrics(st)[0])
    f_graph = summary["f2_final"]
    rel = abs(f_graph - f_end) / abs(f_end)
    rel_oracle = abs(f_graph - summary["f2_exact"]) / abs(summary["f2_exact"])
    out = {"steps": steps, "it_s": steps / secs,
           "host_syncs_per_step": solver.syncs.count / steps,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "f2_final": f_end, "f2_exact": f_exact,
           "graph_vs_eager_rel": rel, "graph_vs_oracle_rel": rel_oracle}
    g = summary["launches_per_step"]
    print(f"{name} routes [{card}]: graph {summary['it_s']:.2f} it/s at "
          f"{summary['host_syncs_per_step']:.2f} host syncs/step, K1 "
          f"{g['stpcg'] + g['stpcg_d2']:.2f} K2 "
          f"{g['polar_so3'] + g['polar_so3_f64']:.2f} launches/step; eager "
          f"{out['it_s']:.2f} it/s at {out['host_syncs_per_step']:.2f} host "
          f"syncs/step, K1 {out['launches_per_step']['stpcg'] + out['launches_per_step']['stpcg_d2']:.2f} "
          f"K2 {out['launches_per_step']['polar_so3'] + out['launches_per_step']['polar_so3_f64']:.2f} "
          f"launches/step; 2f after {steps} steps graph {f_graph:.6f}, "
          f"eager {f_end:.6f} (relative {rel:.3e}), exact oracle at the "
          f"graph route's end {summary['f2_exact']:.6f} ({rel_oracle:.3e})")
    check(rel <= 1e-3, f"{name}: graph and eager routes end {rel} apart in "
          "2f")
    check(rel_oracle <= 1e-3 and abs(f_end - f_exact) <= 1e-3 * abs(f_exact),
          f"{name}: a route's 2f is off the exact oracle")
    summary["eager"] = out
    return out


def polish_certify_paths(root, dev, card, rim, rim_est, paths, launches):
    """The polish and certification paths (module docstring, 8): fills
    `paths` and `launches` for polish_rim, certify_rim, cli_certify and
    sesync_grid. `rim_est` is the rim path's float32 (t, R) after its
    steps."""
    import contextlib
    import io

    import numpy as np
    import torch

    from dpgo_tpu_torch import cli, sesync_cli
    from dpgo_tpu_torch.driver import DPGOSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.sesync.staircase import certify_solution
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    # polish_rim: a float64 solver with the refinement off, started from the
    # rim path's float32 estimate; the global TNT with the rigid coarse
    # level; K2 in float64 in every retraction.
    t0 = time.perf_counter()
    solver = DPGOSolver(rim, num_nodes=NUM_NODES,
                        opts=MMOptions(tnt=TNTParams(max_iterations=0)),
                        dtype=torch.float64, device=dev)
    st0 = solver.initialize(*rim_est)
    f0, g0 = (float(x) for x in solver._metrics(st0))
    torch.cuda.synchronize()
    print(f"polish_rim: float64 solver, {NUM_NODES} nodes, refinement off, "
          f"from rim's float32 estimate: build and initialize "
          f"{time.perf_counter() - t0:.1f} s; 2f {f0:.8f}, 2|grad| {g0:.3e}")

    kw = dict(outer=POLISH_OUTER, tcg=POLISH_TCG, coarse=True)
    reset_counts()
    run = timed_polish(solver, st0, kw, dev)
    launches["polish_rim"] = kernel_counts()
    st, f2, secs, mem = run.pop("state"), run["f2"], run["seconds"], \
        run["memory"]
    outer, cg = run["outer"], run["cg_iterations"]
    f, g = (float(x) for x in solver._metrics(st))
    gap = f2 / RIM_CERTIFIED_2F - 1.0
    print(f"polish_rim [{card}]: {secs:.2f} s, {outer} outer iterations, "
          f"{cg} CG iterations, {run['tnt_host_syncs']} host syncs in the "
          f"TNT ({run['host_syncs']} with the re-initialization), K2 "
          f"float64 launches {launches['polish_rim']['polar_so3_f64']}; 2f "
          f"{f2:.10f} (exact oracle {f:.10f}), {gap:.3e} relative to the "
          f"certified {RIM_CERTIFIED_2F}; 2|grad| {g0:.3e} -> {g:.3e}")
    # The same polish on the host-read route (each loop flag read).
    eager = timed_polish(solver, st0, dict(kw, eager=True), dev)
    del eager["state"]
    rel_eager = abs(f2 - eager["f2"]) / abs(eager["f2"])
    polish_routes("polish_rim", run, eager, rel_eager, card)
    check(rel_eager <= 1e-10, f"polish_rim: the graph and host-read routes' "
          f"2f part by {rel_eager} > 1e-10")
    check(launches["polish_rim"]["polar_so3_f64"] > 0, "polish_rim: K2 "
          f"float64 was not launched: {launches['polish_rim']}")
    check(abs(gap) <= 1e-8, f"polish_rim: 2f {f2} not within 1e-8 of the "
          f"certified {RIM_CERTIFIED_2F}")
    check(g <= g0 / 100, f"polish_rim: 2|grad| fell from {g0} to {g}, less "
          "than 100x")
    # The same polish with K2's plain version.
    twin = copy.copy(solver)
    twin.probs = dataclasses.replace(solver.probs, kernels=False)

    def kernels_only():  # the plain run captures IF / WHILE nodes of its own
        return {k: v for k, v in kernel_counts().items()
                if k != "graph_cond"}

    before = kernels_only()
    plain = timed_polish(twin, st0, kw, dev)
    f2p, secs_p = plain["f2"], plain["seconds"]
    check(kernels_only() == before, "polish_rim: the plain run launched a "
          "kernel")
    rel = abs(f2 - f2p) / abs(f2p)
    print(f"polish_rim with plain versions [{card}]: {secs_p:.2f} s, 2f "
          f"{f2p:.10f}; relative difference {rel:.3e}")
    check(rel <= 1e-10, f"polish_rim: kernel and plain polish disagree in "
          f"2f by {rel} > 1e-10")
    print(f"polish_rim [{card}]: peak allocated {mem['peak'] / 2**20:.1f} "
          f"MiB, {mem['above'] / 2**20:.1f} MiB above the start of the "
          f"polish; problems {problem_bytes(solver.probs) / 2**20:.1f} MiB")
    paths["polish_rim"] = {
        "seconds": secs, "plain_seconds": secs_p, "outer": outer,
        "cg_iterations": cg, "host_syncs": run["host_syncs"],
        "tnt_host_syncs": run["tnt_host_syncs"], "route": run["route"],
        "capture_s": run["capture_s"], "pool_bytes": run["pool_bytes"],
        "eager": eager, "graph_vs_eager": rel_eager,
        "memory": mem, "problem_bytes": problem_bytes(solver.probs),
        "f2_start": f0, "grad2_start": g0, "f2": f2, "f2_plain": f2p,
        "grad2": g, "gap_to_certified": gap,
        "launches": launches["polish_rim"], "card": card}
    R_pol = solver.gather_global(st)[1].cpu().numpy()
    del solver, twin, st, st0, plain

    # certify_rim: the polished rotations, then a negative control.
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    R_bad = R_pol.copy()
    R_bad[2000:4000] = turn @ R_bad[2000:4000]
    reset_counts()
    out = {}
    for name, R in (("polished", R_pol), ("control", R_bad)):
        stats = {}
        ok, lam, bound, fx = certify_solution(rim, R, device=dev,
                                              stats=stats)
        loops = stats["loops"]
        out[name] = dict(certified=bool(ok), lambda_min=lam,
                         bound_2x=2 * bound, f2=2 * fx, **stats)
        print(f"certify_rim, {name} [{card}]: {stats['seconds']:.2f} s "
              f"({stats['apply_S_s']:.2f} s in {stats['apply_S_calls']} "
              f"applications of S on the card, each with its host SuperLU "
              f"round trip; {stats['seconds'] - stats['apply_S_s']:.2f} s "
              f"on the host: scipy S_full, compression, factorization, "
              f"ARPACK), route {stats['route']}, "
              f"{'certified' if ok else 'not certified'}, lambda_min "
              f"{lam:.3e}, bound (2x) {2 * bound:.3e}, 2 fxhat {2 * fx:.10f}; "
              f"host round trips {loops}")
    launches["certify_rim"] = kernel_counts()
    pol, ctl = out["polished"], out["control"]
    check(pol["certified"] and pol["lambda_min"] >= -1e-5, "certify_rim: "
          f"the polished rotations are not certified: {pol}")
    check(abs(pol["f2"] / RIM_CERTIFIED_2F - 1.0) <= 1e-8, "certify_rim: "
          f"2 fxhat {pol['f2']} not within 1e-8 of {RIM_CERTIFIED_2F}")
    check(not ctl["certified"] and ctl["lambda_min"] < -1e-2, "certify_rim: "
          f"the negative control was not rejected: {ctl}")
    paths["certify_rim"] = dict(out, card=card)

    # cli_certify: the CLI's chain on grid3D_synth (float64 default).
    grid = os.path.join(root, GRID3D)
    work = tempfile.TemporaryDirectory()
    here = os.getcwd()
    buf = io.StringIO()
    reset_counts()
    try:
        os.chdir(work.name)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["--dataset", grid, "--num_nodes", "4", "--iters",
                      "20", "--polish", "5", "--lm_polish", "--certify"])
        secs = time.perf_counter() - t0
        rows = np.loadtxt("results_chordal_4_amm.txt", ndmin=2)
        est = np.loadtxt("estimates_trivial.txt", ndmin=2)
    finally:
        os.chdir(here)
        work.cleanup()
    launches["cli_certify"] = kernel_counts()
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if not ln[:1].isdigit()]
    print(f"cli_certify [{card}]: {secs:.2f} s, {rows.shape[0]} result rows, "
          f"2f {rows[0, 2]:.6f} -> {rows[-1, 2]:.12f}, launches "
          f"{launches['cli_certify']}; the CLI printed (iteration rows "
          "left out):\n  " + "\n  ".join(lines))
    cert = [ln for ln in lines if ln.startswith("certification:")]
    check(len(cert) == 1 and "GLOBAL OPT" in cert[0],
          f"cli_certify: certification line {cert}")
    meas_g = read_g2o_file(grid)
    check(rows.shape == (23, 4) and np.isfinite(rows).all(),
          f"cli_certify: result rows {rows.shape}")
    check(est.shape == (meas_g.num_poses * 4, 3),
          f"cli_certify: estimates shape {est.shape}")
    check(abs(rows[-1, 2] / GRID3D_CERTIFIED_2F - 1.0) <= 1e-9,
          f"cli_certify: final 2f {rows[-1, 2]} not within 1e-9 of "
          f"{GRID3D_CERTIFIED_2F}")
    paths["cli_certify"] = {"seconds": secs, "rows": rows.tolist(),
                            "certification": cert[0],
                            "launches": launches["cli_certify"],
                            "card": card}

    # sesync_grid: the staircase through its CLI (the graph route on the
    # card: each rank's TNT captured), then on both routes with their stats.
    reset_counts()
    t0 = time.perf_counter()
    res = sesync_cli.main(["--dataset", grid])
    secs = time.perf_counter() - t0
    launches["sesync_grid"] = kernel_counts()
    print(f"sesync_grid [{card}]: {secs:.2f} s, status {res.status}, rank "
          f"{res.rank}, 2 SDP {2 * res.sdp_val:.12f}, 2 fxhat "
          f"{2 * res.fxhat:.12f}, lambda_min {res.lambda_min:.3e}, launches "
          f"{launches['sesync_grid']}")
    check(res.status == "GlobalOpt" and res.rank == 3,
          f"sesync_grid: {res.status} at rank {res.rank}")
    check(abs(2 * res.sdp_val / GRID3D_SDP_2F - 1.0) <= 1e-8,
          f"sesync_grid: 2 SDP {2 * res.sdp_val} not within 1e-8 of "
          f"{GRID3D_SDP_2F}")
    routes = sesync_routes("sesync_grid", meas_g, dev, card)
    for r in routes.values():
        del r["R"]
    paths["sesync_grid"] = {"seconds": secs, "status": res.status,
                            "rank": res.rank, "sdp_2x": 2 * res.sdp_val,
                            "fxhat_2x": 2 * res.fxhat,
                            "lambda_min": res.lambda_min,
                            "launches": launches["sesync_grid"],
                            "routes": routes, "card": card}


def sesync_routes(name, meas, dev, card) -> dict:
    """sesync(meas) (simplified, float64) on the graph route (each rank's
    TNT captured, `graph=True`) and on the host-read route (`graph=False`)
    in this process: printed side by side (seconds, status, rank, 2 SDP,
    the TNTs' host flag reads, outer iterations, captures, K2 float64
    launches). Held: the graph route taken, the same status and rank, 2 SDP
    within 1e-10 relative, 0 host flag reads in the captured TNTs and K2
    float64 launched. Returns both records (graph route's stats first)."""
    import torch

    from dpgo_tpu_torch.sesync.staircase import sesync

    out = {}
    for graph in (True, False):
        stats = {}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sesync(meas, device=dev, graph=graph, stats=stats)
        torch.cuda.synchronize()
        out["graph" if graph else "host"] = dict(
            seconds=time.perf_counter() - t0, status=res.status,
            rank=res.rank, sdp_2x=2 * res.sdp_val, fxhat_2x=2 * res.fxhat,
            lambda_min=res.lambda_min, launches=kernel_counts(),
            R=res.R, **stats)
    g, h = out["graph"], out["host"]

    def ranks(r):
        return "; ".join(
            f"rank {x['rank']}: TNT {x['seconds']:.3f} s, {x['outer']} "
            f"outer, {x['tnt_host_syncs']} host syncs"
            + (f", captured in {x['capture_s']:.2f} s after a "
                            f"{x['warmup_s']:.2f} s warm-up, replay "
                            f"{x['replay_s']:.3f} s, pools "
                            f"{x['pool_bytes'] / 2**20:.1f} MiB"
                            if "capture_s" in x else "")
            for x in r["ranks"])

    rel = abs(g["sdp_2x"] / h["sdp_2x"] - 1.0)
    print(f"{name} graph vs host-read route [{card}]: {g['seconds']:.2f} vs "
          f"{h['seconds']:.2f} s; routes {g['route']} / {h['route']}; "
          f"{g['status']} at rank {g['rank']} vs {h['status']} at rank "
          f"{h['rank']}; 2 SDP {g['sdp_2x']:.12f} vs {h['sdp_2x']:.12f} "
          f"(relative {rel:.3e}); lambda_min {g['lambda_min']:.3e} vs "
          f"{h['lambda_min']:.3e}; K2 float64 launches "
          f"{g['launches']['polar_so3_f64']} vs "
          f"{h['launches']['polar_so3_f64']}; LOBPCG certificates "
          f"{len(g['lobpcg'])} vs {len(h['lobpcg'])}; graph: {ranks(g)}; "
          f"host: {ranks(h)}")
    check(g["route"] == "graph" and h["route"] == "host",
          f"{name}: routes {g['route']} / {h['route']}")
    check((g["status"], g["rank"]) == (h["status"], h["rank"]),
          f"{name}: the routes end in {g['status']} at rank {g['rank']} and "
          f"{h['status']} at rank {h['rank']}")
    check(rel <= 1e-10, f"{name}: 2 SDP parts between the routes by {rel}")
    check(all(x["tnt_host_syncs"] == 0 for x in g["ranks"]),
          f"{name}: a captured TNT read the card on the host: {g['ranks']}")
    check(g["launches"]["polar_so3_f64"] > 0, f"{name}: K2 float64 was not "
          f"launched: {g['launches']}")
    return out


def sesync_rim4096_path(root, dev, card, paths, launches):
    """sesync_rim4096 (module docstring, 8): SE-Sync at its dense limit.
    The staircase on both routes (sesync_routes; GlobalOpt held), then
    certify_solution(method="lobpcg") on its estimate and on a rotated
    control (poses 1000-1999 turned 0.5 rad about z, as certify_rim turns
    rim's) on the graph route (the LOBPCG captured) and the host-read
    route: the same verdicts held (estimate certified, control rejected),
    lambda_min within min_eig_tol between the routes, 0 host syncs in the
    captured LOBPCG. The Chebyshev preconditioner is taken where the plain
    LOBPCG does not resolve the sign within its budget; the choice is
    printed."""
    import numpy as np

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.sesync.staircase import certify_solution

    path = ensure_rim(root, RIM4096, floors=2)
    meas = read_g2o_file(path)
    check(meas.num_poses == 4096, f"sesync_rim4096: {meas.num_poses} poses")
    routes = sesync_routes("sesync_rim4096", meas, dev, card)
    # The path's launches: the graph route's run (counts set to 0 before it).
    launches["sesync_rim4096"] = routes["graph"]["launches"]
    g = routes["graph"]
    check(g["status"] == "GlobalOpt", f"sesync_rim4096: {g['status']}")
    R = g.pop("R")
    routes["host"].pop("R")

    tol = 1e-5  # certify_solution's and SESyncOpts' min_eig_tol
    th = 0.5
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    R_bad = R.copy()
    R_bad[1000:2000] = turn @ R_bad[1000:2000]
    budget = 20000  # min_eig_lobpcg's max_iters under certify_solution
    cert = {}
    for name, cand, want in (("estimate", R, True), ("control", R_bad,
                                                     False)):
        precon = "auto"
        for graph in (True, False):
            stats = {}
            reset_counts()
            ok, lam, bound, fx = certify_solution(
                meas, cand, method="lobpcg", precon=precon, device=dev,
                graph=graph, stats=stats)
            if graph and stats["lobpcg"]["iterations"] >= budget \
                    and precon == "auto":
                # The plain LOBPCG did not resolve the sign: Chebyshev.
                precon = "chebyshev"
                stats = {}
                reset_counts()
                ok, lam, bound, fx = certify_solution(
                    meas, cand, method="lobpcg", precon=precon, device=dev,
                    graph=graph, stats=stats)
            cert[(name, graph)] = dict(
                certified=bool(ok), lambda_min=lam, bound_2x=2 * bound,
                f2=2 * fx, precon=precon, launches=kernel_counts(), **stats)
        cg, ch = cert[(name, True)], cert[(name, False)]
        lg, lh = cg["lobpcg"], ch["lobpcg"]
        print(f"sesync_rim4096 certify {name} [{card}]: precon {precon} "
              f"({'the plain LOBPCG resolved the sign within its budget' if precon == 'auto' else 'the plain LOBPCG did not resolve the sign within its budget'}); "
              f"graph vs host-read route: {cg['seconds']:.2f} vs "
              f"{ch['seconds']:.2f} s in all, LOBPCG {lg['seconds']:.3f} vs "
              f"{lh['seconds']:.3f} s, {lg['iterations']} vs "
              f"{lh['iterations']} iterations, its replay "
              f"{lg['replay_s']:.3f} s (captured in {lg['capture_s']:.2f} s "
              f"after a {lg['warmup_s']:.2f} s warm-up, pools "
              f"{lg['pool_bytes'] / 2**20:.1f} MiB) vs {ch['apply_S_s']:.3f} "
              f"s in the host route's applications of S; applications of S "
              f"{cg['apply_S_calls']} vs {ch['apply_S_calls']}; host syncs "
              f"{cg['host_syncs']} vs {ch['host_syncs']} (loops "
              f"{cg['loops']} vs {ch['loops']}); "
              f"{'certified' if cg['certified'] else 'not certified'} vs "
              f"{'certified' if ch['certified'] else 'not certified'}, "
              f"lambda_min {cg['lambda_min']:.3e} vs {ch['lambda_min']:.3e}; "
              f"K2 float64 launches {cg['launches']['polar_so3_f64']} vs "
              f"{ch['launches']['polar_so3_f64']}")
        check(lg["route"] == "graph" and lh["route"] == "host",
              f"sesync_rim4096 certify {name}: routes {lg['route']} / "
              f"{lh['route']}")
        check(cg["certified"] == ch["certified"] == want,
              f"sesync_rim4096 certify {name}: verdicts {cg['certified']} "
              f"(graph) / {ch['certified']} (host), want {want}")
        check(abs(cg["lambda_min"] - ch["lambda_min"]) <= tol,
              f"sesync_rim4096 certify {name}: lambda_min "
              f"{cg['lambda_min']} vs {ch['lambda_min']}")
        check(cg["host_syncs"] == 0 and "lobpcg" not in cg["loops"],
              f"sesync_rim4096 certify {name}: the captured LOBPCG read the "
              f"card on the host ({cg['host_syncs']}, {cg['loops']})")
    paths["sesync_rim4096"] = {
        "routes": routes,
        "certify": {f"{n}_{'graph' if gr else 'host'}": v
                    for (n, gr), v in cert.items()},
        "launches": launches["sesync_rim4096"], "card": card}


def pcm_aa_paths(root, dev, card, make_solver, rim, rim_est, paths,
                 launches, to_profile):
    """PCM and Anderson acceleration (module docstring, 9): fills `paths`,
    `launches` and `to_profile` for pcm_rim, aa_rim and cli_pcm. `rim_est`
    is the rim path's float32 (t, R) after its steps."""
    import contextlib
    import io

    import numpy as np
    import torch

    from dpgo_tpu_torch import cli
    from dpgo_tpu_torch.graph import make_partition
    from dpgo_tpu_torch.io import native
    from dpgo_tpu_torch.io.g2o import read_g2o_file, write_g2o_file
    from dpgo_tpu_torch.objective import EdgeData, evaluate_f
    from dpgo_tpu_torch.pcm import (CliqueRoutes, PCMOptions, pcm_filter,
                                    pcm_filter_incremental)
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.synthetic import with_outliers
    from dpgo_tpu_torch.utils import HostSyncs

    # pcm_rim: rim with every tenth inter-node edge an outlier, the
    # centralized chordal start of the corrupted graph, both PCM pipelines.
    meas, bad = with_outliers(rim, np.random.default_rng(SEED), NUM_NODES)
    part = make_partition(meas.num_poses, NUM_NODES)
    inter = np.nonzero(part.node_of[meas.i] != part.node_of[meas.j])[0]
    good = np.setdiff1d(inter, bad)
    t0 = time.perf_counter()
    R0 = chordal_initialization(meas)
    t_0 = recover_translations_global(meas, R0)
    chordal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(native.native_available(), "pcm_rim: the native library did not "
          f"build: {native._Loaded.failed}")
    print(f"pcm_rim: native library {native.LIB_PATH} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s; chordal start of the corrupted "
          f"graph {chordal_s:.2f} s (host)")

    def run(fn, tol, where, **kw):
        CliqueRoutes.reset()
        syncs = HostSyncs()
        if where.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, keep = fn(meas, NUM_NODES, t_0, R0, PCMOptions(tolerance=tol),
                     device=where, dtype=torch.float64, syncs=syncs, **kw)
        if where.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        routes = dict(CliqueRoutes.counts)
        check(routes["native"] > 0 and routes["python"] == 0
              and routes["heuristic"] == 0,
              f"pcm_rim: the cliques did not run natively: {routes}")
        return keep, secs, syncs.count, routes

    cpu = torch.device("cpu")
    out = {}
    for tol in (PCM_TOL, 0.2):
        for name, fn, kw in (("batch", pcm_filter, {}),
                             ("incremental", pcm_filter_incremental,
                              dict(batch=PCM_BATCH))):
            keep, secs, reads, routes = run(fn, tol, dev, **kw)
            keep_cpu, secs_cpu, _, _ = run(fn, tol, cpu, **kw)
            check(bool((keep == keep_cpu).all()), f"pcm_rim: {name} keep "
                  f"mask at {tol} on the card differs from the CPU's in "
                  f"{int((keep != keep_cpu).sum())} edges")
            out[(tol, name)] = dict(
                seconds=secs, cpu_seconds=secs_cpu, mask_reads=reads,
                clique_routes=routes, kept=int(keep.sum()),
                outliers_kept=int(keep[bad].sum()),
                inliers_dropped=int((~keep[good]).sum()), keep=keep)
            print(f"pcm_rim {name} at tolerance {tol} [{card}]: {secs:.3f} s "
                  f"on the card ({reads} mask reads, cliques {routes}), "
                  f"{secs_cpu:.3f} s on the CPU, keep masks equal; "
                  f"outliers kept {out[(tol, name)]['outliers_kept']}/"
                  f"{len(bad)}, inlier inter-node edges dropped "
                  f"{out[(tol, name)]['inliers_dropped']}/{len(good)}")
    b3 = out[(PCM_TOL, "batch")]
    print(f"pcm_rim: batch filter at {PCM_TOL}: outliers kept "
          f"{b3['outliers_kept']}/{len(bad)} (JAX package on a CPU: 0/53), "
          f"inliers dropped {b3['inliers_dropped']}/{len(good)} (JAX: "
          "143/474)")
    check(b3["outliers_kept"] == 0, "pcm_rim: an outlier survived the batch "
          "filter at tolerance 3.0")
    disagree = {}
    for tol in (PCM_TOL, 0.2):
        diff = out[(tol, "batch")]["keep"] != out[(tol, "incremental")][
            "keep"]
        disagree[tol] = int(diff.sum())
        print(f"pcm_rim: batch vs incremental (batch {PCM_BATCH}) at "
              f"{tol}: {disagree[tol]} edges kept by one and not the other "
              "(the loop error is not symmetric; ROADMAP Queue 3)")
    filtered = meas.select(b3["keep"])

    # The filtered graph through AMM-PGO#, refined preset, trivial loss.
    solver, init = make_solver(filtered, f"pcm_rim: {DATASET} with "
                               f"{len(bad)} outliers, after PCM at "
                               f"{PCM_TOL}", opts=MMOptions(accelerated=True))
    paths["pcm_rim"], launches["pcm_rim"], st = run_path(
        "pcm_rim", solver, init, ("polar_so3", "stpcg"), card)
    def f2(graph, t, R):
        edges = EdgeData.from_measurements(graph, dtype=torch.float64,
                                           device=dev)
        t, R = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                for x in (t, R))
        return 2.0 * float(evaluate_f(edges, t, R))

    t, R = (x.double() for x in solver.gather_global(st))
    f_clean = f2(rim, t, R)
    # Whether the filtered solve is short of its optimum, or the filtered
    # graph's optimum lies elsewhere: the rim path's estimate (near the
    # clean optimum) scored on the filtered graph.
    f_filtered_at_rim = f2(filtered, *rim_est)
    print(f"pcm_rim: estimate after {ITERS} steps on the clean rim graph "
          f"2f {f_clean:.6f}, beside the clean rim path's 2f at {ITERS} "
          f"{paths['rim']['f2_final']:.6f} and 2f* {RIM_CERTIFIED_2F}; the "
          f"rim path's estimate on the filtered graph 2f "
          f"{f_filtered_at_rim:.6f} (the filtered solve's "
          f"{paths['pcm_rim']['f2_final']:.6f})")
    check(np.isfinite(f_clean), "pcm_rim: non-finite clean 2f")
    paths["pcm_rim"].update(
        chordal_s=chordal_s, clean_f2=f_clean,
        filtered_f2_at_rim_estimate=f_filtered_at_rim, outliers=len(bad),
        inlier_inter_edges=len(good), batch_incremental_disagree=disagree,
        pcm={f"{name}@{tol}": {k: v for k, v in o.items() if k != "keep"}
             for (tol, name), o in out.items()})
    to_profile.append(("pcm_rim", solver, init))
    del st

    # aa_rim: Anderson-accelerated MM on the clean rim graph (K2 only).
    solver, init = make_solver(rim, f"aa_rim: {DATASET}, "
                               "MMOptions(scheme='aa')",
                               opts=MMOptions(scheme="aa"))
    paths["aa_rim"], launches["aa_rim"], _ = run_path(
        "aa_rim", solver, init, ("polar_so3",), card, monotone=True,
        fused=False)
    print(f"aa_rim: 2f at {ITERS} {paths['aa_rim']['f2_final']:.6f} beside "
          f"the AMM-PGO# rim path's {paths['rim']['f2_final']:.6f} "
          f"(2f* {RIM_CERTIFIED_2F})")
    to_profile.append(("aa_rim", solver, init))

    # cli_pcm: the CLI on the corrupted graph's .g2o, streamed PCM.
    work = tempfile.TemporaryDirectory()
    g2o = os.path.join(work.name, "rim_outliers.g2o")
    t_true = recover_translations_global(meas, R0)
    write_g2o_file(g2o, t_true, R0, meas)
    back = read_g2o_file(g2o)
    R1 = chordal_initialization(back)
    _, keep_want = pcm_filter_incremental(
        back, NUM_NODES, recover_translations_global(back, R1), R1,
        PCMOptions(tolerance=PCM_TOL), batch=PCM_BATCH, device=dev,
        dtype=torch.float32)
    want = f"PCM kept {keep_want.sum()}/{len(keep_want)} edges"
    argv = ["--dataset", g2o, "--num_nodes", str(NUM_NODES), "--pcm",
            "--pcm_tolerance", str(PCM_TOL), "--pcm_stream", str(PCM_BATCH),
            "--f32", "--iters", "30"]
    here = os.getcwd()
    buf = io.StringIO()
    reset_counts()
    try:
        os.chdir(work.name)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        secs = time.perf_counter() - t0
        rows = np.loadtxt(f"results_chordal_{NUM_NODES}_amm.txt", ndmin=2)
        est = np.loadtxt("estimates_trivial.txt", ndmin=2)
    finally:
        os.chdir(here)
        work.cleanup()
    launches["cli_pcm"] = kernel_counts()
    lines = buf.getvalue().splitlines()
    kept = [ln for ln in lines if ln.startswith("PCM kept")]
    print(f"cli_pcm [{card}]: {secs:.2f} s; {kept}; {rows.shape[0]} result "
          f"rows, 2f {rows[0, 2]:.6f} -> {rows[-1, 2]:.6f}, launches "
          f"{launches['cli_pcm']}")
    check(kept == [want], f"cli_pcm: {kept} != [{want!r}]")
    check(rows.shape == (31, 4) and np.isfinite(rows).all(),
          f"cli_pcm: result rows {rows.shape}")
    check(est.shape == (back.num_poses * 4, 3) and np.isfinite(est).all(),
          f"cli_pcm: estimates shape {est.shape}")
    check(rows[-1, 2] < rows[0, 2], "cli_pcm: 2f did not decrease")
    for kern in ("polar_so3", "stpcg"):
        check(launches["cli_pcm"][kern] > 0, f"cli_pcm: kernel {kern} was "
              f"not launched: {launches['cli_pcm']}")
    paths["cli_pcm"] = {"seconds": secs, "pcm_line": kept[0],
                        "rows": rows.tolist(),
                        "launches": launches["cli_pcm"], "card": card}


def ensure_rim(root: str, rel: str = RIM100K, floors: int = 50) -> str:
    """The path of a rim_synth graph of 32 x 64 poses per floor (RIM100K:
    50 floors; RIM4096: 2), made with tools/make_rim.py (numpy only) in a
    subprocess when the file is absent."""
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "make_rim.py"),
             "--rows", "32", "--cols", "64", "--floors", str(floors),
             "--out", path],
            check=True, timeout=600, capture_output=True, text=True).stdout
        print(f"{out.strip()} in {time.perf_counter() - t0:.1f} s")
    return path


def check_no_dense_block(name, probs, seg: bool):
    """Off the dense path no [N, n0 d, n0 d] operator image exists, and on
    the segment path no [N, n0, n0] array either: those fields are the
    [N, 1, 1] placeholders, and no tensor of the problem is that large."""
    import torch
    N, n0 = probs.pose_mask.shape
    fields = ["mG00_d", "mG01_d", "mG11_d", "Hred_d", "precon_dense"]
    limit = N * (n0 * probs.d) ** 2
    if seg:
        fields += ["Minv_red", "SU"]
        limit = N * n0 * n0
    for f in fields:
        check(tuple(getattr(probs, f).shape) == (N, 1, 1),
              f"{name}: {f} has shape {tuple(getattr(probs, f).shape)}")
    tensors = {k: v for k, v in vars(probs).items()
               if isinstance(v, torch.Tensor)}
    nbytes = sum(v.numel() * v.element_size() for v in tensors.values())
    largest = max((v.numel(), k) for k, v in tensors.items())
    check(largest[0] < limit, f"{name}: field {largest[1]} holds "
          f"{largest[0]} elements, as many as a dense block ({limit})")
    print(f"{name}: problem tensors {nbytes / 1e6:.1f} MB, "
          f"largest {largest[1]} {tuple(getattr(probs, largest[1]).shape)}; "
          f"device memory allocated {torch.cuda.memory_allocated() / 1e6:.0f}"
          f" MB, peak {torch.cuda.max_memory_allocated() / 1e6:.0f} MB")


def mG00_matvec_edgewise(p, v):
    """mG00 v in the edge-wise form (the alternative to the block form
    `NodeProblem.mG00_matvec` keeps): the intra Laplacian and the inter
    diagonal 2 w_bar tau through gathers and one index_add_, xi on real
    poses and 1 on padded ones."""
    import torch
    d = v.shape[-1]
    dv = p.a_tau[..., None] * (p._g(v, p.a_i) - p._g(v, p.a_j))
    w = (2.0 * p._sw(p.e_tau))[..., None] * p._g(v, p.e_self)
    out = torch.where(p.pose_mask, p.xi, 1.0).to(v.dtype)[..., None] * v
    idx = torch.cat([p._fi.view(dv.shape[:2]), p._fj.view(dv.shape[:2]),
                     p._fs.view(w.shape[:2])], 1).reshape(-1)
    out.view(-1, d).index_add_(0, idx,
                               torch.cat([dv, -dv, w], 1).reshape(-1, d))
    return out


def solve_mG00_seg_fixed_trips(p, rhs, x0=None, syncs=None):
    """`NodeProblem._solve_mG00_seg` as a loop of exactly seg_cg_iters trips
    that carries the continuation condition as a device flag and reads
    nothing on the host (the alternative to the host-read loop the package
    keeps): a node that has converged keeps its state, so the result is
    the same."""
    import torch

    from dpgo_tpu_torch.ops.stpcg import sel
    r_full = p._deflate_null(rhs)
    rr_ref = (r_full * r_full).sum(1)
    if x0 is None:
        x, r = torch.zeros_like(rhs), r_full
    else:
        x = p._deflate_null(x0)
        r = r_full - p._deflate_null(p.mG00_matvec(x))
    z = p._precondition_t_seg(r)
    pk, rz = z, (r * z).sum(1)
    tol2 = p.seg_cg_tol * p.seg_cg_tol
    for _ in range(p.seg_cg_iters):
        running = ((r * r).sum(1) > tol2 * rr_ref).any(1)
        Ap = p._deflate_null(p.mG00_matvec(pk))
        pAp = (pk * Ap).sum(1)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0),
                            0.0)
        x_new = x + alpha[:, None, :] * pk
        r_new = r - alpha[:, None, :] * Ap
        z_new = p._precondition_t_seg(r_new)
        rz_new = (r_new * z_new).sum(1)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        p_new = z_new + beta[:, None, :] * pk
        x, r, pk = (sel(running, x_new, x), sel(running, r_new, r),
                    sel(running, p_new, pk))
        rz = sel(running, rz_new, rz)
    return x


def phase_segment_choices(solver, init, card, steps=25):
    """The two choices of the segment path, measured on the rim100k solver
    (proximal only): the block matvec against the edge-wise one, and the
    host-read CG loop against the fixed-trip one. Each alternative is held
    to the package's result, timed alone (the matvec), and run in the path
    in turns (package, alternative, alternative, package; `steps` steps
    each from the state after 20 steps): it/s and host syncs per step."""
    import torch

    from dpgo_tpu_torch.problem import NodeProblem
    from dpgo_tpu_torch.utils import HostSyncs
    p = solver.probs
    gen = torch.Generator(device=p.nvec.device).manual_seed(SEED)
    v = torch.randn(p.nvec.shape, generator=gen, dtype=p.nvec.dtype,
                    device=p.nvec.device)
    blk, edge = p.mG00_matvec(v), mG00_matvec_edgewise(p, v)
    err = float((blk - edge).abs().max() / blk.abs().max())
    ms_blk = cuda_ms(lambda: p.mG00_matvec(v), 200)
    ms_edge = cuda_ms(lambda: mG00_matvec_edgewise(p, v), 200)
    nbytes = sum(x.numel() * x.element_size()
                 for x in (p.seg_diag, p.seg_blk, v, blk))
    print(f"mG00_matvec at {tuple(v.shape)} [{card}]: block form (kept) "
          f"{ms_blk:.4f} ms per call ({nbytes / 1e6:.1f} MB of blocks and "
          f"vectors), edge-wise form {ms_edge:.4f} ms; max relative "
          f"difference {err:.3e}")
    check(err <= 1e-4, f"mG00_matvec: block and edge-wise forms differ by "
          f"{err}")

    rhs = blk
    x0 = 0.9 * p._deflate_null(v)
    a = p._solve_mG00_seg(rhs, x0)
    b = solve_mG00_seg_fixed_trips(p, rhs, x0)
    cg_err = float((a - b).abs().max() / a.abs().max())
    print(f"_solve_mG00_seg: host-read loop (kept) against the fixed-trip "
          f"loop, max relative difference {cg_err:.3e}")
    check(cg_err <= 1e-4, f"the two CG loops differ by {cg_err}")

    st0, k0 = solver.run_steps(solver.initialize(*init), 0, 20)

    def timed():
        # The host-read route: a captured step would not see the methods
        # swapped in below.
        solver.syncs = HostSyncs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = solver.run_steps_eager(st0, k0, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (steps / secs, solver.syncs.count / steps,
                2.0 * float(st.fobj.sum()))

    def in_turns(attr, alt):
        kept = getattr(NodeProblem, attr)
        runs = {"kept": [], "alternative": []}
        try:
            for which in ("kept", "alternative", "alternative", "kept"):
                setattr(NodeProblem, attr, alt if which == "alternative"
                        else kept)
                runs[which].append(timed())
        finally:
            setattr(NodeProblem, attr, kept)
        return runs

    out = {"matvec_block_ms": ms_blk, "matvec_edgewise_ms": ms_edge,
           "matvec_rel_diff": err, "cg_rel_diff": cg_err}
    for label, attr, alt in (
            ("matvec", "mG00_matvec", mG00_matvec_edgewise),
            ("cg_loop", "_solve_mG00_seg", solve_mG00_seg_fixed_trips)):
        runs = in_turns(attr, alt)
        f_all = [r[2] for rs in runs.values() for r in rs]
        spread = (max(f_all) - min(f_all)) / abs(f_all[0])
        print(f"rim100k_prox, {label} in turns (kept, alternative, "
              f"alternative, kept), {steps} steps each [{card}]: kept "
              + ", ".join(f"{r[0]:.2f} it/s at {r[1]:.2f} syncs/step"
                          for r in runs["kept"])
              + "; alternative "
              + ", ".join(f"{r[0]:.2f} it/s at {r[1]:.2f} syncs/step"
                          for r in runs["alternative"])
              + f"; 2f after the steps within {spread:.3e} of each other")
        check(spread <= 1e-4, f"{label}: the runs end {spread} apart in 2f")
        out[label] = {k: [list(r) for r in rs] for k, rs in runs.items()}
    return out


def timed_polish(solver, st, kw, dev) -> dict:
    """solver.polish(st, **kw) timed (ending in a synchronize): seconds,
    2f, the state it returns, outer and CG iterations, route, capture
    seconds and pool bytes (graph route), host syncs in all and in its TNT
    alone, and the peak of allocated memory."""
    import torch

    from dpgo_tpu_torch.utils import HostSyncs
    solver.syncs = HostSyncs()
    mem0 = peak_start(dev)
    t0 = time.perf_counter()
    st2, f2 = solver.polish(st, **kw)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    stats = {k: v for k, v in solver.polish_stats.items() if k != "history"}
    return dict(stats, seconds=secs, f2=f2, state=st2,
                host_syncs=solver.syncs.count, memory=peak_read(dev, mem0))


def polish_routes(name, run, eager, rel, card):
    """Print a polish on the graph route beside the same polish on the
    host-read route (`timed_polish` records) and hold the graph route's
    TNT to no host sync."""
    mib = 2.0 ** 20
    print(f"{name} graph vs host-read route [{card}]: {run['seconds']:.2f} "
          f"vs {eager['seconds']:.2f} s; {run['outer']} vs {eager['outer']}"
          f" outer, {run['cg_iterations']} vs {eager['cg_iterations']} CG "
          f"iterations; host syncs in the TNT {run['tnt_host_syncs']} vs "
          f"{eager['tnt_host_syncs']} ({run['host_syncs']} vs "
          f"{eager['host_syncs']} with the re-initialization); captured in "
          f"{run['capture_s']:.2f} s after a {run['warmup_s']:.2f} s "
          f"warm-up, pools {run['pool_bytes'] / mib:.1f} MiB; peak "
          f"allocated {run['memory']['peak'] / mib:.1f} vs "
          f"{eager['memory']['peak'] / mib:.1f} MiB "
          f"({run['memory']['above'] / mib:.1f} vs "
          f"{eager['memory']['above'] / mib:.1f} above the start); 2f "
          f"relative difference {rel:.3e}")
    check(run["route"] == "graph" and eager["route"] == "host",
          f"{name}: routes {run['route']} / {eager['route']}")
    check(run["tnt_host_syncs"] == 0, f"{name}: the captured TNT read the "
          f"card on the host {run['tnt_host_syncs']} times")


def large_block_paths(root, dev, card, make_solver, rim, paths, launches,
                      to_profile):
    """The paths above the dense limit (module docstring, 7): the three
    rim100k segment paths with the two measured choices, and rim_edgewise.
    Fills `paths`, `launches` and `to_profile`; returns rim100k's
    measurements and start."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.losses import Loss, loss_weight
    from dpgo_tpu_torch.objective import edge_sqnorms
    from dpgo_tpu_torch.solvers.mm import MMOptions, resolve_preconditioner
    from dpgo_tpu_torch.solvers.tnt import TNTParams
    from dpgo_tpu_torch.synthetic import with_outliers

    path = ensure_rim(root)
    t0 = time.perf_counter()
    big = read_g2o_file(path)
    print(f"rim100k: {RIM100K} read in {time.perf_counter() - t0:.1f} s")
    refined = MMOptions(accelerated=True)
    prox = MMOptions(accelerated=True, tnt=TNTParams(max_iterations=0))
    torch.cuda.reset_peak_memory_stats()
    solver, init = make_solver(big, f"rim100k: {RIM100K}", opts=refined)
    big_init = init
    check(solver.probs.seg and not solver.probs.dense,
          "rim100k: the problem is not on the segment path")
    check_no_dense_block("rim100k", solver.probs, seg=True)

    # Proximal only: the configuration of the JAX bench's rim_synth_100k row.
    solver_p = copy.copy(solver)
    solver_p.opts = prox
    paths["rim100k_prox"], launches["rim100k_prox"], st = run_path(
        "rim100k_prox", solver_p, init, ("polar_so3",), card, steps=100,
        fused=False)
    eager_route("rim100k_prox", solver_p, init, card, paths["rim100k_prox"])
    print(f"rim100k_prox: 2f after 100 steps "
          f"{paths['rim100k_prox']['f2_final']:.2f} (exact "
          f"{paths['rim100k_prox']['f2_exact']:.2f}); the JAX package's "
          f"bench recorded {RIM100K_JAX_2F_100:.2f} for this configuration "
          "(reported, not held)")
    # polish_rim100k: the global polish of that state, without the coarse
    # level: the segment branch of the node-block preconditioner (segment
    # mG11 inverses, segment-Schwarz CG translation solves) and K2 at
    # [102400, 3, 3] in float32.
    kw = dict(outer=POLISH_100K_OUTER, tcg=POLISH_100K_TCG, coarse=False)
    reset_counts()
    run = timed_polish(solver_p, st, kw, dev)
    launches["polish_rim100k"] = kernel_counts()
    loops = device_loop_stats()
    f2 = run["f2"]
    f_ex = float(solver_p._metrics(run.pop("state"))[0])
    eager = timed_polish(solver_p, st, dict(kw, eager=True), dev)
    del eager["state"]
    rel = abs(f2 - eager["f2"]) / abs(eager["f2"])
    print(f"polish_rim100k [{card}]: 2f "
          f"{paths['rim100k_prox']['f2_exact']:.2f} -> {f2:.2f} (exact "
          f"{f_ex:.2f}); launches {launches['polish_rim100k']}, device "
          f"loops [entries, trips per entry] {loops}; problems "
          f"{problem_bytes(solver_p.probs) / 2**20:.1f} MiB")
    polish_routes("polish_rim100k", run, eager, rel, card)
    check(np.isfinite(f2) and f2 <= RIM100K_JAX_2F_100, "polish_rim100k: "
          f"2f {f2} not finite or above {RIM100K_JAX_2F_100}")
    check(launches["polish_rim100k"]["polar_so3"] > 0, "polish_rim100k: K2 "
          "was not launched")
    check(loops.get("seg_cg", [0])[0] > 0, "polish_rim100k: no "
          "segment-Schwarz CG solve ran")
    check(rel <= SPLIT_100K_RTOL, f"polish_rim100k: the graph and host-read "
          f"routes' 2f part by {rel} > {SPLIT_100K_RTOL}")
    paths["polish_rim100k"] = dict(
        run, f2_exact=f_ex, problem_bytes=problem_bytes(solver_p.probs),
        loops=loops, launches=launches["polish_rim100k"], eager=eager,
        graph_vs_eager=rel, card=card)
    del st
    paths["rim100k_prox"]["choices"] = phase_segment_choices(solver_p, init,
                                                             card)
    to_profile.append(("rim100k_prox", solver_p, init))

    paths["rim100k_refined"], launches["rim100k_refined"], _ = run_path(
        "rim100k_refined", solver, init, ("polar_so3",), card,
        steps=REFINED_100K_STEPS, fused=False, runs=1)
    # The proximal path made two runs of 100 steps.
    k2_prox = launches["rim100k_prox"]["polar_so3"] * REFINED_100K_STEPS \
        // 200
    k2_ref = launches["rim100k_refined"]["polar_so3"]
    stp = paths["rim100k_refined"]["loops"].get("stpcg", [0, 0.0])
    print(f"rim100k_refined: K2 launches {k2_ref} against the proximal "
          f"path's {k2_prox} over the same steps; the coupled TNT ran "
          f"{stp[0]} STPCG solves of {stp[1]:.2f} iterations each")
    check(k2_ref > k2_prox and stp[0] > 0, "rim100k_refined: the coupled "
          "TNT did not run")
    to_profile.append(("rim100k_refined", solver, init))

    # Huber + dynamic rescale on the segment problem.
    meas_r, bad = with_outliers(big, np.random.default_rng(SEED + 5),
                                NUM_NODES)
    opts_r = MMOptions(accelerated=True, rescale="dynamic")
    solver, init = make_solver(meas_r, f"rim100k_robust: {RIM100K} with "
                               f"{len(bad)} outlier inter-node edges, Huber, "
                               "dynamic rescale", opts=opts_r,
                               loss=Loss.HUBER, loss_reg=LOSS_REG)
    check(solver.probs.seg, "rim100k_robust: not on the segment path")
    paths["rim100k_robust"], launches["rim100k_robust"], st = run_path(
        "rim100k_robust", solver, init, ("polar_so3",), card, steps=40,
        fused=False, runs=1)
    check(solver.problems(st).dynamic, "rim100k_robust: the iterate's "
          "problems are not reweighted")
    sw_min = float(st.scale_w.min())
    t, R = solver.gather_global(st)
    w = loss_weight(Loss.HUBER, edge_sqnorms(solver.edges, t, R), LOSS_REG)
    is_bad = torch.zeros(len(meas_r), dtype=torch.bool, device=dev)
    is_bad[torch.as_tensor(bad, device=dev)] = True
    w_out = float(w[is_bad].mean())
    w_in = float(w[solver.edges.is_inter & ~is_bad].mean())
    print(f"rim100k_robust: min scale_w {sw_min:.4g}; mean final Huber "
          f"weight {w_out:.4g} on the {len(bad)} outliers, {w_in:.4g} on "
          "the inlier inter-node edges")
    check(sw_min < 1.0, "rim100k_robust: dynamic rescale never fired")
    check(w_out < w_in, f"rim100k_robust: outlier weight {w_out} not below "
          f"inlier weight {w_in}")
    paths["rim100k_robust"].update(min_scale_w=sw_min, outlier_weight=w_out,
                                   inlier_weight=w_in)
    to_profile.append(("rim100k_robust", solver, init))
    del st

    # rim_synth with 6 nodes: above dense_limit, under segment_limit.
    solver, init = make_solver(rim, f"rim_edgewise: {DATASET}",
                               num_nodes=EDGEWISE_NODES, opts=refined)
    check(not solver.probs.dense and not solver.probs.seg,
          "rim_edgewise: the problem is not on the edge-wise path")
    check(resolve_preconditioner(solver.probs, solver.opts) == "jacobi",
          "rim_edgewise: the preconditioner did not resolve to jacobi")
    check_no_dense_block("rim_edgewise", solver.probs, seg=False)
    paths["rim_edgewise"], launches["rim_edgewise"], _ = run_path(
        "rim_edgewise", solver, init, ("polar_so3",), card, steps=100,
        fused=False, runs=1)
    to_profile.append(("rim_edgewise", solver, init))
    return big, big_init


# The sharded phase (module docstring, 10): what each run holds, by name.
SHARDED_STEPS, SHARDED_HALO_STEPS, SHARDED_STAR_STEPS = 150, 20, 50
SHARDED_100K_STEPS = 25
# How far the split float32 polish_rim100k may part from the single-process
# polish of the same state (relative 2f): the two sum in another order on
# the card (index_add_ over ranks' shares), so only rounding apart.
SPLIT_100K_RTOL = 1e-5
# Collective timeout of the spawned groups (a rank that waits this long for
# the others raises) and the deadline of a whole spawn.
SHARDED_TIMEOUT, SHARDED_DEADLINE = 180.0, 900.0
# How far K1 / K2 launches (and collectives, where the master fallbacks
# differ) per step may part between the graph and host-read routes of one
# sharded run: each follows the refinement gate, restarts and fallbacks,
# which float32 rounding in the card's scatter order flips on a few steps
# (nccl1 rim on an H100 80GB HBM3 at 700 W: K1 1.013 vs 0.947, K2 2.053
# vs 2.007 per step).
LAUNCH_SPREAD = 0.1


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sharded_polish(solver, st, kw, device) -> dict:
    """One sharded polish from `st` (polish keywords `kw`) on this rank:
    seconds, 2f before and after, the solver's polish_stats (outer and CG
    iterations, exchanges, collectives, bytes, host copies), host syncs,
    K2 launches, peak memory, what the rank holds, and its own rows of the
    start (global frame, on the host) for the parent's single-process
    polish of the same state."""
    import numpy as np
    import torch

    from dpgo_tpu_torch.utils import HostSyncs

    f_start = float(solver._metrics(st)[0])
    start = tuple(x.cpu().numpy() for x in solver.own_rows(st))
    solver.syncs = HostSyncs()
    reset_counts()
    mem0 = peak_start(device)
    t0 = time.perf_counter()
    st2, f2 = solver.polish(st, **kw)
    _sync(device)
    secs = time.perf_counter() - t0
    mem = peak_read(device, mem0)
    k = kernel_counts()
    stats = {k_: v for k_, v in solver.polish_stats.items()
             if k_ != "history"}
    probs = solver.probs
    rows = {getattr(probs, f.name).shape[0]
            for f in dataclasses.fields(probs)
            if isinstance(getattr(probs, f.name), torch.Tensor)}
    return {"seconds": secs, "f2_start": f_start, "f2": f2, "start": start,
            "finite": bool(np.isfinite(f2)
                           and torch.isfinite(st2.Z.t).all()
                           and torch.isfinite(st2.Z.R).all()),
            **stats, "host_syncs": solver.syncs.count,
            "loops": {n: list(v) for n, v in solver.syncs.loops.items()},
            "k2": k["polar_so3"] + k["polar_so3_f64"], "memory": mem,
            "problem_bytes": problem_bytes(probs),
            "own_problems_only": (rows == {solver.nodes_per_rank}
                                  and not hasattr(solver, "_full_probs")),
            "edges": int(solver.pose_split().edges.edges.i.shape[0]),
            "poses": solver.pose_split().hi - solver.pose_split().lo}


def probe_nccl_conditional(comm, device, nodes: dict | None = None) -> dict:
    """Can an NCCL collective be captured inside a conditional node's body?
    On this rank's group (`comm`, spmd.Collectives), each case captured
    alone (graph_nodes.warm_and_capture), replayed once and held against
    the same code run eagerly: an all_reduce and an all_gather at the top
    level of a graph (the control), inside an IF body, and inside a WHILE
    body of three trips. Returns {case: "ok" or what failed}. With
    `nodes`, fills nodes[case] with the types of the graph nodes the first
    collective of the case's capture recorded (graph_nodes.
    capture_node_types of the graph its stream captures into, before and
    after the call), or with the types before a call that raised."""
    import collections

    import torch

    from dpgo_tpu_torch.ops import graph_nodes
    from dpgo_tpu_torch.utils import bounded_while, current_route, device_cond

    x = torch.arange(1.0, 9.0, device=device)
    one = torch.ones((), dtype=torch.int64, device=device)
    case = [None]

    def recorded(op):
        def run(v):
            if nodes is None or current_route() != "capture" \
                    or case[0] in nodes:
                return op(v)
            before = graph_nodes.capture_node_types()
            try:
                out = op(v)
            except Exception:
                nodes[case[0]] = ["raised after"] + before
                raise
            added = (collections.Counter(graph_nodes.capture_node_types())
                     - collections.Counter(before))
            nodes[case[0]] = sorted(added.elements())
            return out
        return run

    @recorded
    def reduce(v):
        return comm.all_reduce(v)

    @recorded
    def gather(v):
        return comm.all_gather(v[None])[comm.rank]

    def in_if(op):
        return lambda: device_cond(x.sum() > 0, lambda: op(2.0 * x),
                                   lambda: 0.0 * x)

    def in_while(op):
        def body(c, running):
            return (op(c[0]) + 1.0, c[1] + 1)
        return lambda: bounded_while(
            3, lambda c: (c[1] < 4)[None], body, (x, one))[0]

    cases = {"top_all_reduce": lambda: reduce(2.0 * x),
             "top_all_gather": lambda: gather(2.0 * x),
             "if_all_reduce": in_if(reduce), "if_all_gather": in_if(gather),
             "while_all_reduce": in_while(reduce),
             "while_all_gather": in_while(gather)}
    out = {}
    for name, fn in cases.items():
        case[0] = name
        want = fn().clone()
        try:
            got, _ = graph_nodes.run_once(device, fn)
            torch.cuda.synchronize(device)
            out[name] = "ok" if torch.equal(got, want) else (
                f"differs from eager: {got.tolist()} vs {want.tolist()}")
        except RuntimeError as exc:
            out[name] = f"{type(exc).__name__}: {str(exc)[:300]}"
    return out


def collective_counts() -> dict:
    """Collectives, their bytes and host copies since the last reset, from
    the device counters spmd.Collectives bumps inside each collective
    (inside a captured step too, at every replay)."""
    from dpgo_tpu_torch.parallel.spmd import Collectives
    from dpgo_tpu_torch.utils import DeviceCounters
    return {n: DeviceCounters.read(n) for n in Collectives.COUNTERS}


def sharded_rank(rank, world_size, device, jobs, card, probe_first=True,
                 log=None):
    """One rank of the sharded phase: for each job, build the sharded
    solver on this rank's nodes once (in the job's type, float32 unless it
    names another), then for each of the job's runs (a halo strategy and a
    step count, the deterministic ones last) reset the kernel and
    collective counts, initialize from the job's start, run the steps with
    history and read the counts (device counters; the Python totals too,
    which equal them on the host-read route). Over NCCL the steps take the
    graph route (the step captured, replayed once per step); over gloo the
    host-read route. A run with `polish` (polish keywords) then polishes
    the state it reached (sharded_polish). A `timed` run then runs the
    steps again from the same start without history, timed (as run_slice
    times the single-process paths); a run with `eager` then runs them on
    the host-read route with history, timed; a run with `profile` (at,
    steps) adds profile_path's window (and the host-read route's, with
    `eager`). Over NCCL (with `probe_first`) the first record also
    carries the answer of probe_nccl_conditional. `log(text)` (optional)
    is told as each part of a run ends. Returns one record per run."""
    import numpy as np
    import torch

    import dpgo_tpu_torch  # noqa: F401  (sets true-f32 matmuls)
    from dpgo_tpu_torch.parallel import spmd
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.solvers.tnt import TNTParams

    t_rank = time.perf_counter()
    log = log or (lambda text: None)
    # The ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    out = []
    probe = None
    for job in jobs:
        cls = (spmd.ShardedDPGOStarSolver if job["cls"] == "star"
               else spmd.ShardedDPGOSolver)
        tnt = job.get("tnt")
        opts = MMOptions(accelerated=True,
                         **({} if tnt is None else {"tnt": TNTParams(**tnt)}))
        t0 = time.perf_counter()
        base = cls(job["meas"], NUM_NODES, opts=opts,
                   dtype=getattr(torch, job.get("dtype", "float32")),
                   device=device)
        _sync(device)
        build_s = time.perf_counter() - t0
        if probe_first and probe is None and base.comm.backend == "nccl":
            probe = probe_nccl_conditional(base.comm, device)
        for run in job["runs"]:
            if run["deterministic"]:
                torch.use_deterministic_algorithms(True, warn_only=True)
            # One build serves every strategy: the solver reads `halo` at
            # each exchange.
            solver = copy.copy(base)
            solver.halo = run["halo"]
            if hasattr(solver, "reset_fallbacks"):
                solver.reset_fallbacks()
            steps = run["steps"]
            t0 = time.perf_counter()
            st = solver.initialize(*job["init"])
            _sync(device)
            init_s = time.perf_counter() - t0
            reset_counts()
            solver.comm.reset()
            comm = solver.comm
            rec = {
                "key": run["key"], "rank": rank,
                "nodes": [solver.node_lo, solver.node_hi],
                "backend": comm.backend, "device": str(device),
                "build_s": build_s, "init_s": init_s, "steps": steps}
            if not steps:
                rec["polish"] = sharded_polish(solver, st, run["polish"],
                                               device)
                log(f"{run['key']}: polish ({rec['polish']['route']} route) "
                    f"{rec['polish']['seconds']:.2f} s")
                if run.get("eager"):
                    rec["polish_eager"] = sharded_polish(
                        solver, st, dict(run["polish"], eager=True), device)
                    log(f"{run['key']}: polish, host-read route, "
                        f"{rec['polish_eager']['seconds']:.2f} s")
                out.append(rec)
                del solver, st
                continue
            syncs0 = solver.syncs.count
            t0 = time.perf_counter()
            st, _, (f, g) = solver.run_steps_history(st, 0, steps)
            _sync(device)
            secs = time.perf_counter() - t0
            log(f"{run['key']}: {steps} steps with history, {secs:.2f} s")
            launches = kernel_counts()
            coll = collective_counts()
            fh = f.cpu().numpy()
            rec.update({
                "route": "graph" if solver._graph_route() else "host",
                "history_it_s": steps / secs, "it_s": steps / secs,
                "host_syncs_per_step": (solver.syncs.count - syncs0) / steps,
                "f2": fh,
                "finite": bool(np.isfinite(fh).all()
                               and torch.isfinite(st.Z.t).all()
                               and torch.isfinite(st.Z.R).all()),
                "collectives_per_step": coll["collectives"] / steps,
                "bytes_per_step": coll["collective_bytes"] / steps,
                "host_copies_per_step":
                    coll["collective_host_copies"] / steps,
                "device_counts": coll,
                "python_counts": {"collectives": comm.calls,
                                  "collective_bytes": comm.bytes,
                                  "collective_host_copies":
                                      comm.host_copies},
                "graph": solver.graph_stats(),
                "k1": launches["stpcg"], "k2": launches["polar_so3"],
                "fallbacks": dict(getattr(solver, "fallbacks", {})),
                "deterministic": run["deterministic"], "timed": False})
            if run.get("polish"):
                rec["polish"] = sharded_polish(solver, st, run["polish"],
                                               device)
            if run["timed"]:
                st = solver.initialize(*job["init"])
                _sync(device)
                syncs0 = solver.syncs.count
                t0 = time.perf_counter()
                solver.run_steps(st, 0, steps)
                _sync(device)
                rec.update(it_s=steps / (time.perf_counter() - t0),
                           host_syncs_per_step=(solver.syncs.count - syncs0)
                           / steps, timed=True)
                log(f"{run['key']}: timed run {steps / rec['it_s']:.2f} s")
            if run.get("eager"):
                rec["eager"] = sharded_eager_run(solver, job["init"], steps,
                                                 device)
                log(f"{run['key']}: host-read route "
                    f"{steps / rec['eager']['it_s']:.2f} s")
            if run.get("profile"):
                label = f"sharded {run['key']} rank {rank} ({comm.backend})"
                rec["profile"] = profile_path(label, solver, job["init"],
                                              card, *run["profile"])
                if run.get("eager"):
                    rec["profile_eager"] = profile_path(
                        label, solver, job["init"], card, *run["profile"],
                        eager=True)
            out.append(rec)
            del solver, st
        del base
    # Seconds from the call to the return, on the last record.
    out[-1]["rank_s"] = time.perf_counter() - t_rank
    out[0]["probe"] = probe
    return out


def sharded_eager_run(solver, init, steps, device) -> dict:
    """`steps` steps with history on the host-read route
    (run_steps_history_eager) from `init`, timed: it/s, host syncs,
    collectives, bytes and host copies per step (device counters), K1 and
    K2 launches, master fallbacks and the 2f history."""
    import numpy as np

    st = solver.initialize(*init)
    _sync(device)
    reset_counts()
    if hasattr(solver, "reset_fallbacks"):
        solver.reset_fallbacks()
    syncs0 = solver.syncs.count
    t0 = time.perf_counter()
    _, _, (f, _) = solver.run_steps_history_eager(st, 0, steps)
    _sync(device)
    secs = time.perf_counter() - t0
    launches, coll = kernel_counts(), collective_counts()
    fh = f.cpu().numpy()
    return {"it_s": steps / secs,
            "host_syncs_per_step": (solver.syncs.count - syncs0) / steps,
            "collectives_per_step": coll["collectives"] / steps,
            "bytes_per_step": coll["collective_bytes"] / steps,
            "host_copies_per_step": coll["collective_host_copies"] / steps,
            "k1": launches["stpcg"], "k2": launches["polar_so3"],
            "fallbacks": dict(getattr(solver, "fallbacks", {})),
            "f2": fh, "finite": bool(np.isfinite(fh).all())}


def _runs(prefix, halos, steps, deterministic=False, timed=False):
    """Run specs keyed `prefix_halo`, numbered where a halo repeats."""
    return [{"key": f"{prefix}_{h}" + (f"_{i}" if halos.count(h) > 1
                                       else ""),
             "halo": h, "steps": steps, "deterministic": deterministic,
             "timed": timed}
            for i, h in enumerate(halos)]


def _warm_it_s(solver, init, steps):
    """it/s of `steps` steps without history from the start `init`."""
    import torch
    st = solver.initialize(*init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(st, 0, steps)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def sharded_paths(card, rim, rim_init, rim_est, big, big_init, refs, paths,
                  launches, rim_solver, big_solver):
    """The sharded phase (module docstring, 10). `refs` holds the
    single-process paths it is held to (rim, star, rim100k_prox: their 2f
    histories, and their it/s printed beside; polish_rim and
    polish_rim100k: their 2f and peak memory). `rim_est` is the polish's
    start (rim's float32 estimate). The host's speed drifts
    over a call, so the NCCL runs' it/s are also set beside rim's
    single-process solver (`rim_solver`) timed here just before and just
    after their spawn. The split polish_rim100k is held to rim100k_prox's
    single-process solver (`big_solver`) polishing the same 25-step state
    here (same_state_polish). Fills `paths["sharded"]` and one `launches`
    entry per run, summed over the ranks."""
    import torch

    from dpgo_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    halos = ["boundary", "boundary", "gather", "ring"]
    # The split polish of rim (path 8's polish_rim on the ranks).
    polish_job = dict(meas=rim, init=rim_est, cls="hash", dtype="float64",
                      tnt={"max_iterations": 0},
                      runs=[dict(key="polish_rim", halo="boundary", steps=0,
                                 deterministic=False, timed=False,
                                 polish=dict(outer=POLISH_OUTER,
                                             tcg=POLISH_TCG, coarse=True))])
    rim_job = dict(meas=rim, init=rim_init, cls="hash",
                   runs=_runs("rim", ["boundary"], SHARDED_STEPS, timed=True))
    star_job = dict(meas=rim, init=rim_init, cls="star",
                    runs=_runs("star", ["boundary"], SHARDED_STAR_STEPS,
                               timed=True))
    # NCCL at world size 1 (the graph route) also runs rim and AMM-PGO* on
    # the host-read route in the same rank, and profiles rim's window on
    # both routes (their it/s beside the single process's).
    rim_profiled = dict(rim_job, runs=[dict(r, eager=True,
                                            profile=(PROFILE_AT,
                                                     PROFILE_STEPS))
                                       for r in rim_job["runs"]])
    star_eager = dict(star_job, runs=[dict(r, eager=True)
                                      for r in star_job["runs"]])
    # nccl1's split polish on the graph route (the TNT captured, its
    # collectives inside) and then on the host-read route, in the same rank.
    polish_eager = dict(polish_job, runs=[dict(r, eager=True)
                                          for r in polish_job["runs"]])
    jobs4 = [
        # Two runs of one strategy, then each strategy, in the default mode
        # and (last) under deterministic algorithms.
        dict(rim_job, runs=rim_job["runs"]
             + _runs("halos", halos, SHARDED_HALO_STEPS)
             + _runs("halos_deterministic", halos, SHARDED_HALO_STEPS,
                     deterministic=True)),
        star_job,
        dict(meas=big, init=big_init, cls="hash", tnt={"max_iterations": 0},
             runs=[dict(r, polish=dict(outer=POLISH_100K_OUTER,
                                       tcg=POLISH_100K_TCG, coarse=False))
                   for r in _runs("rim100k_prox", ["boundary"],
                                  SHARDED_100K_STEPS, timed=True)]),
        polish_job,
    ]
    # The deterministic runs go last: the setting stays on in the process.
    jobs4 = jobs4[1:] + jobs4[:1]
    runs = [("nccl1", "nccl", ["cuda:0"], [rim_profiled, star_eager,
                                          polish_eager]),
            ("gloo4", "gloo", ["cuda:0"] * 4, jobs4)]
    if torch.cuda.device_count() >= 4:
        runs.append(("nccl4", "nccl", [f"cuda:{r}" for r in range(4)],
                     [rim_job]))
    else:
        print(f"sharded: nccl4 not run: {torch.cuda.device_count()} card(s) "
              "(NCCL takes one rank per card)")
    out = {}
    for name, backend, devices, jobs in runs:
        if backend == "nccl":
            single_before = _warm_it_s(rim_solver, rim_init, SHARDED_STEPS)
        t0 = time.perf_counter()
        res = spawn(sharded_rank, len(devices), backend=backend,
                    devices=devices, args=(jobs, card),
                    timeout=SHARDED_TIMEOUT,
                    deadline=SHARDED_DEADLINE)
        secs = time.perf_counter() - t0
        if backend == "nccl":
            single = [single_before,
                      _warm_it_s(rim_solver, rim_init, SHARDED_STEPS)]
            r0 = [r for r in res[0] if r["key"] == "rim_boundary"][0]
            ratio = r0["it_s"] / (sum(single) / 2)
            print(f"sharded {name} [{card}]: single-process rim (this "
                  f"process, without history) {single[0]:.2f} it/s just "
                  f"before the spawn, {single[1]:.2f} just after; rank 0's "
                  f"rim {r0['it_s']:.2f} it/s is {ratio:.3f} x their mean")
        rank_s = max(recs[-1]["rank_s"] for recs in res)
        probe = res[0][0]["probe"]
        if probe is not None:
            print(f"sharded {name} probe [{card}]: NCCL collectives captured "
                  "inside conditional-node bodies, each held equal to eager: "
                  + ", ".join(f"{k} {v}" for k, v in probe.items()))
            check(all(v == "ok" for v in probe.values()), f"sharded {name}: "
                  f"an NCCL collective in a conditional body failed: {probe}")
        print(f"sharded {name} [{card}]: {len(devices)} rank(s) on "
              f"{devices}, backend {res[0][0]['backend']}, spawn "
              f"{secs:.1f} s, of which in the ranks' function {rank_s:.1f} s "
              "(the rest: process start, imports, group set-up)")
        out[name] = {"ranks": len(devices), "backend": res[0][0]["backend"],
                     "spawn_s": secs, "rank_s": rank_s, "runs": {}}
        if backend == "nccl":
            out[name].update(single_process_rim_it_s=single,
                             rim_vs_single=ratio)
        for i, rec in enumerate(res[0]):
            key = rec["key"]
            mine = [rank_recs[i] for rank_recs in res]
            if rec["steps"]:
                out[name]["runs"][key] = _sharded_record(
                    f"sharded {name} {key}", mine, refs, card)
                launches[f"sharded_{name}_{key}"] = {
                    "polar_so3": sum(r["k2"] for r in mine),
                    "polar_so3_f64": 0,
                    "stpcg": sum(r["k1"] for r in mine), "stpcg_d2": 0}
            if "polish" in rec:
                pkey = "polish_rim" if key == "polish_rim" \
                    else "polish_rim100k"
                recs = [r["polish"] for r in mine]
                same = (None if pkey == "polish_rim" else same_state_polish(
                    big_solver, recs, run_kw(jobs, key)))
                out[name]["runs"][pkey] = _sharded_polish_record(
                    f"sharded {name} {pkey}", pkey, recs, refs, card, same)
                if "polish_eager" in rec:
                    out[name]["runs"][pkey]["eager"] = _split_polish_routes(
                        f"sharded {name} {pkey}", recs,
                        [r["polish_eager"] for r in mine], card)
                f64 = pkey == "polish_rim"
                launches[f"sharded_{name}_{pkey}"] = {
                    "polar_so3": 0 if f64 else sum(r["k2"] for r in recs),
                    "polar_so3_f64": sum(r["k2"] for r in recs) if f64
                    else 0, "stpcg": 0, "stpcg_d2": 0}
        for job in ("halos", "halos_deterministic"):
            if f"{job}_gather" in out[name]["runs"]:
                _same_as_one_strategy(f"sharded {name} {job}",
                                      out[name]["runs"], job,
                                      hold=job == "halos_deterministic")
        for run in out[name]["runs"].values():
            run.pop("f2", None)
    paths["sharded"] = dict(out, seconds=time.perf_counter() - t_phase,
                            card=card)
    print(f"sharded: phase {paths['sharded']['seconds']:.1f} s [{card}]")


def run_kw(jobs, key):
    """The polish keywords of the run `key` among `jobs`."""
    return next(r["polish"] for job in jobs for r in job["runs"]
                if r["key"] == key)


def same_state_polish(solver, recs, kw) -> dict:
    """The single-process polish (keywords `kw`) on `solver` of the state
    the ranks of a split polish started from: their own rows (`recs`, in
    rank order, each rank's poses contiguous) joined. Returns its 2f
    before and after and its seconds; its launches count nowhere."""
    import numpy as np

    t = np.concatenate([r["start"][0] for r in recs])
    R = np.concatenate([r["start"][1] for r in recs])
    st = solver.initialize(t, R)
    f_start = float(solver._metrics(st)[0])
    _sync(solver.device)
    t0 = time.perf_counter()
    _, f2 = solver.polish(st, **kw)
    _sync(solver.device)
    return {"f2_start": f_start, "f2": f2,
            "seconds": time.perf_counter() - t0}


def _sharded_record(label, mine, refs, card):
    """Check and print one sharded run (one record per rank): equal
    histories on every rank, finite, the kernels launched on every rank,
    and the 2f history held to the single-process run's (rim's for the
    halo strategies' runs). On the graph route: no host sync; with its
    host-read run (`eager`) in the same rank, the 2f histories within 1e-3
    at every step, and K1 / K2 launches and collectives per step (device
    counters) within LAUNCH_SPREAD (collectives exactly where the master
    took the same fallbacks). On the host-read route the device counts of
    the collectives equal the Python totals."""
    import numpy as np

    key = mine[0]["key"]
    f = mine[0]["f2"]
    for r in mine:
        check(r["key"] == key, f"{label}: the ranks ran different runs")
        check(r["finite"], f"{label}: rank {r['rank']} non-finite")
        check(np.array_equal(r["f2"], f), f"{label}: rank {r['rank']}'s 2f "
              "history differs from rank 0's")
        check(r["k2"] > 0, f"{label}: rank {r['rank']} launched no K2")
        if not key.startswith("rim100k"):
            check(r["k1"] > 0, f"{label}: rank {r['rank']} launched no K1")
        check(r["fallbacks"] == mine[0]["fallbacks"],
              f"{label}: the ranks' master fallbacks differ")
        if r["route"] == "graph":
            check(r["host_syncs_per_step"] == 0, f"{label}: rank "
                  f"{r['rank']} read the card on the host on the graph "
                  f"route: {r['host_syncs_per_step']} per step")
        else:
            check(r["device_counts"] == r["python_counts"], f"{label}: the "
                  f"collectives' device counts {r['device_counts']} differ "
                  f"from the Python totals {r['python_counts']}")
    single = refs[next((k for k in ("rim100k_prox", "star")
                        if key.startswith(k)), "rim")]
    ref = single["f2_history"]
    n = min(len(f), len(ref))
    gap = float(np.max(np.abs(f[:n] - ref[:n]) / np.abs(ref[:n])))
    r0 = mine[0]
    timing = ("without history (the single process "
              f"{single['it_s']:.2f}), {r0['history_it_s']:.2f} it/s with"
              if r0["timed"] else "with history")
    print(f"{label} [{card}]: backend {r0['backend']}, {r0['it_s']:.2f} it/s "
          f"{timing} (rank 0; ranks {[round(r['it_s'], 2) for r in mine]}), "
          f"{r0['host_syncs_per_step']:.2f} host syncs, "
          f"{r0['collectives_per_step']:.2f} collectives, "
          f"{r0['bytes_per_step']:.0f} B, {r0['host_copies_per_step']:.2f} "
          f"host copies per step per rank; K1 per rank "
          f"{[r['k1'] for r in mine]}, K2 per rank {[r['k2'] for r in mine]};"
          f" build {max(r['build_s'] for r in mine):.1f} s, initialize "
          f"{max(r['init_s'] for r in mine):.2f} s; 2f at {len(f)} "
          f"{f[-1]:.6f}, single-process {ref[n - 1]:.6f}, largest relative "
          f"gap over {n} steps {gap:.3e}"
          + (f"; fallbacks {r0['fallbacks']}" if r0["fallbacks"] else ""))
    check(gap <= 1e-3, f"{label}: 2f parts from the single-process run by "
          f"{gap} > 1e-3")
    eager = r0.get("eager")
    if eager is not None:
        _graph_vs_eager(label, r0, eager, steps=len(f), card=card)
    if r0["graph"] is not None:
        g = r0["graph"]
        print(f"{label} [{card}]: route {r0['route']}, step captured in "
              f"{g['capture_s']:.2f} s after a {g['warmup_s']:.2f} s "
              f"warm-up; pools {g['pool_bytes'] / 2**20:.1f} MiB")
    return {"it_s": [r["it_s"] for r in mine], "timed": r0["timed"],
            "route": r0["route"], "graph": r0["graph"],
            "eager": None if eager is None else {
                k: v for k, v in eager.items() if k != "f2"},
            "profile_eager": r0.get("profile_eager"),
            "history_it_s": [r["history_it_s"] for r in mine],
            "single_process_it_s": single["it_s"],
            "host_syncs_per_step": r0["host_syncs_per_step"],
            "profile": r0.get("profile"), "f2_final": float(f[-1]),
            "gap_to_single": gap, "steps": len(f),
            "collectives_per_step": r0["collectives_per_step"],
            "bytes_per_step": r0["bytes_per_step"],
            "host_copies_per_step": r0["host_copies_per_step"],
            "k1_per_rank": [r["k1"] for r in mine],
            "k2_per_rank": [r["k2"] for r in mine],
            "build_s": [r["build_s"] for r in mine],
            "init_s": [r["init_s"] for r in mine],
            "fallbacks": r0["fallbacks"], "backend": r0["backend"],
            "deterministic": r0["deterministic"], "f2": f.tolist()}


def _graph_vs_eager(label, r0, eager, steps, card):
    """Rank 0's graph-route run against its host-read run from the same
    start in the same rank (module docstring, 10): printed and held."""
    import numpy as np

    f, fe = r0["f2"], eager["f2"]
    gap = float(np.max(np.abs(f - fe) / np.abs(fe)))
    per = {n: (r0[n] / steps, eager[n] / steps) for n in ("k1", "k2")}
    per["collectives"] = (r0["collectives_per_step"],
                          eager["collectives_per_step"])
    print(f"{label} graph vs host-read route, same rank [{card}]: "
          f"{r0['it_s']:.2f} vs {eager['it_s']:.2f} it/s "
          f"({r0['it_s'] / eager['it_s']:.2f} x); host syncs/step "
          f"{r0['host_syncs_per_step']:.2f} vs "
          f"{eager['host_syncs_per_step']:.2f}; per step K1 "
          f"{per['k1'][0]:.3f} vs {per['k1'][1]:.3f}, K2 {per['k2'][0]:.3f} "
          f"vs {per['k2'][1]:.3f}, collectives {per['collectives'][0]:.3f} "
          f"vs {per['collectives'][1]:.3f}, bytes {r0['bytes_per_step']:.0f}"
          f" vs {eager['bytes_per_step']:.0f}; fallbacks {r0['fallbacks']} "
          f"vs {eager['fallbacks']}; 2f largest relative gap over {steps} "
          f"steps {gap:.3e}")
    check(eager["finite"], f"{label}: the host-read run is not finite")
    check(gap <= 1e-3, f"{label}: the graph route's 2f parts from the "
          f"host-read route's by {gap} > 1e-3")
    check(r0["route"] == "graph" and eager["host_syncs_per_step"] > 0,
          f"{label}: not a graph route against a host-read route")
    for name, (a, b) in per.items():
        if name == "collectives" and r0["fallbacks"] == eager["fallbacks"]:
            check(a == b, f"{label}: {a} collectives per step on the graph "
                  f"route, {b} on the host-read route")
        check(abs(a - b) <= LAUNCH_SPREAD, f"{label}: {name} per step {a} "
              f"on the graph route, {b} on the host-read route")


def _sharded_polish_record(label, key, recs, refs, card, same=None):
    """Check and print one split polish (one record per rank): 2f equal and
    finite on every rank, K2 launched on every rank, every rank's problems
    its own nodes' only; polish_rim: 2f within 1e-9 of the single-process
    polish_rim's in this call and within 1e-8 of RIM_CERTIFIED_2F;
    polish_rim100k: 2f not above the start's, within SPLIT_100K_RTOL of
    the single-process polish of the same state (`same`), and a
    segment-Schwarz CG solve on every rank. Prints per rank the seconds,
    iterations, host syncs, traffic per CG iteration, K2 launches and peak
    memory beside the single-process polish's."""
    r0 = recs[0]
    for r in recs:
        check(r["finite"], f"{label}: non-finite on a rank")
        check(r["f2"] == r0["f2"], f"{label}: 2f differs between ranks: "
              f"{[q['f2'] for q in recs]}")
        check(r["k2"] > 0, f"{label}: a rank launched no K2: "
              f"{[q['k2'] for q in recs]}")
        check(r["own_problems_only"], f"{label}: a rank holds problems of "
              "nodes not its own")
    single = refs[key]
    rel = r0["f2"] / single["f2"] - 1.0
    if key == "polish_rim":
        gap = r0["f2"] / RIM_CERTIFIED_2F - 1.0
        check(abs(rel) <= 1e-9, f"{label}: 2f {r0['f2']} parts from the "
              f"single-process polish's {single['f2']} by {rel}")
        check(abs(gap) <= 1e-8, f"{label}: 2f {r0['f2']} not within 1e-8 "
              f"of the certified {RIM_CERTIFIED_2F}")
        quality = (f"{gap:.3e} relative to the certified "
                   f"{RIM_CERTIFIED_2F}")
    else:
        check(r0["f2"] <= r0["f2_start"], f"{label}: 2f rose from "
              f"{r0['f2_start']} to {r0['f2']}")
        check(all(r["loops"].get("seg_cg", [0])[0] > 0 for r in recs),
              f"{label}: a rank ran no segment-Schwarz CG solve")
        rel_same = r0["f2"] / same["f2"] - 1.0
        check(abs(rel_same) <= SPLIT_100K_RTOL, f"{label}: 2f {r0['f2']} "
              f"parts from the single-process polish of the same state "
              f"({same['f2']}) by {rel_same}")
        quality = (f"from {r0['f2_start']:.4f}; the single-process polish "
                   f"of the same state {same['f2_start']:.4f} -> "
                   f"{same['f2']:.4f} in {same['seconds']:.2f} s, relative "
                   f"{rel_same:.3e}")
    ref_name = ("single-process" if key == "polish_rim" else
                "the single process's polish of its 100-step state")
    cg = max(r0["cg_iterations"], 1)
    mib = 2.0 ** 20
    print(f"{label} [{card}]: 2f {r0['f2']:.10f} ({quality}; "
          f"{ref_name} {single['f2']:.10f}, relative {rel:.3e}); "
          f"{r0['outer']} outer, {r0['cg_iterations']} CG iterations; per "
          f"CG iteration {r0['exchanges'] / cg:.3f} exchanges, "
          f"{r0['collectives'] / cg:.3f} collectives, "
          f"{r0['bytes'] / cg:.0f} B, {r0['host_copies'] / cg:.3f} host "
          "copies per rank")
    for r in recs:
        print(f"{label} rank: {r['seconds']:.2f} s, {r['host_syncs']} host "
              f"syncs, K2 {r['k2']}, {r['poses']} poses, {r['edges']} "
              f"edges, problems {r['problem_bytes'] / mib:.1f} MiB "
              f"(single process {single['problem_bytes'] / mib:.1f}), "
              f"peak allocated {r['memory']['peak'] / mib:.1f} MiB, "
              f"{r['memory']['above'] / mib:.1f} above the polish's start "
              f"(single process {single['memory']['peak'] / mib:.1f}, "
              f"{single['memory']['above'] / mib:.1f}); seg_cg "
              f"{r['loops'].get('seg_cg')}")
    return {"f2": r0["f2"], "f2_start": r0["f2_start"], "rel_to_single": rel,
            "same_state": same,
            "outer": r0["outer"], "cg_iterations": r0["cg_iterations"],
            "exchanges": r0["exchanges"], "collectives": r0["collectives"],
            "bytes": r0["bytes"], "host_copies": r0["host_copies"],
            "seconds": [r["seconds"] for r in recs],
            "host_syncs": [r["host_syncs"] for r in recs],
            "k2_per_rank": [r["k2"] for r in recs],
            "memory": [r["memory"] for r in recs],
            "problem_bytes": [r["problem_bytes"] for r in recs],
            "single_memory": single["memory"],
            "single_problem_bytes": single["problem_bytes"],
            "poses": [r["poses"] for r in recs],
            "edges": [r["edges"] for r in recs]}


def _split_polish_routes(label, recs, eager, card) -> dict:
    """Print a split polish on the graph route (`recs`, one record per rank:
    sharded_polish) beside the same polish on the host-read route in the
    same ranks (`eager`), and hold: the graph route taken over NCCL, no
    host sync in it (the re-initialization included), 2f within 1e-10 of
    the host route's, exchanges and collectives per CG iteration within
    0.1 of the host route's (device counters on both), K2 launched.
    Returns the host route's numbers."""
    mib = 2.0 ** 20
    for g, h in zip(recs, eager):
        cg, ch = max(g["cg_iterations"], 1), max(h["cg_iterations"], 1)
        per = {k: (g[k] / cg, h[k] / ch) for k in ("exchanges",
                                                    "collectives", "bytes")}
        rel = abs(g["f2"] / h["f2"] - 1.0)
        print(f"{label} graph vs host-read route, same rank [{card}]: "
              f"{g['seconds']:.2f} vs {h['seconds']:.2f} s; routes "
              f"{g['route']} / {h['route']}; {g['outer']} vs {h['outer']} "
              f"outer, {g['cg_iterations']} vs {h['cg_iterations']} CG "
              f"iterations; host syncs {g['host_syncs']} vs "
              f"{h['host_syncs']}; per CG iteration "
              + ", ".join(f"{k} {a:.3f} vs {b:.3f}" for k, (a, b)
                          in per.items())
              + f"; K2 float64 {g['k2']} vs {h['k2']}; captured in "
              f"{g['capture_s']:.2f} s after a {g['warmup_s']:.2f} s "
              f"warm-up, pools {g['pool_bytes'] / mib:.1f} MiB; peak "
              f"allocated {g['memory']['peak'] / mib:.1f} vs "
              f"{h['memory']['peak'] / mib:.1f} MiB; 2f {g['f2']:.10f} vs "
              f"{h['f2']:.10f} (relative {rel:.3e})")
        check(g["route"] == "graph" and h["route"] == "host",
              f"{label}: routes {g['route']} / {h['route']}")
        check(g["host_syncs"] == 0, f"{label}: the captured polish read the "
              f"card on the host {g['host_syncs']} times")
        check(rel <= 1e-10, f"{label}: the graph and host-read routes' 2f "
              f"part by {rel} > 1e-10")
        for k in ("exchanges", "collectives"):
            a, b = per[k]
            check(abs(a - b) <= LAUNCH_SPREAD, f"{label}: {k} per CG "
                  f"iteration {a} (graph) vs {b} (host)")
        check(g["k2"] > 0 and h["k2"] > 0, f"{label}: K2 not launched")
    h = eager[0]
    return {k: h[k] for k in ("seconds", "f2", "outer", "cg_iterations",
                              "host_syncs", "exchanges", "collectives",
                              "bytes", "k2", "route")}


def _same_as_one_strategy(label, runs, job, hold):
    """The exchange only moves bytes: the strategies must part from the
    first boundary run no more than a second boundary run does (held with
    `hold`, the deterministic runs; printed always). `runs` is keyed
    `job_halo[_i]`."""
    import numpy as np

    base = np.asarray(runs[f"{job}_boundary_0"]["f2"])

    def spread(key):
        f = np.asarray(runs[key]["f2"])
        return float(np.max(np.abs(f - base) / np.abs(base)))

    same = spread(f"{job}_boundary_1")
    others = {k: spread(f"{job}_{k}") for k in ("gather", "ring")}
    print(f"{label}: 2f relative spread from the first boundary run: "
          f"second boundary run {same:.3e}, gather {others['gather']:.3e}, "
          f"ring {others['ring']:.3e}")
    if hold:
        for k, v in others.items():
            check(v <= same, f"{label}: {k} parts from boundary by {v}, "
                  f"more than two boundary runs ({same})")


def main() -> int:
    import faulthandler

    import torch
    faulthandler.enable()  # a fatal signal prints every thread's stack
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    import dpgo_tpu_torch  # noqa: F401  (sets true-f32 matmuls)
    from dpgo_tpu_torch import cli
    from dpgo_tpu_torch.chordal import DChordalConfig
    from dpgo_tpu_torch.driver import DPGOSolver, DPGOStarSolver
    from dpgo_tpu_torch.io.g2o import read_g2o_file, write_g2o_file
    from dpgo_tpu_torch.losses import Loss, loss_weight
    from dpgo_tpu_torch.objective import EdgeData, edge_sqnorms, evaluate_f
    from dpgo_tpu_torch.ops import _build
    from dpgo_tpu_torch.ops.eigen import lambda_max_lanczos
    from dpgo_tpu_torch.sesync import (chordal_initialization,
                                       recover_translations_global)
    from dpgo_tpu_torch.solvers.mm import MMOptions
    from dpgo_tpu_torch.synthetic import manhattan_world, with_outliers

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_s, marks = {}, [t_start]

    def lap(name):
        """Seconds since the previous lap, printed and kept."""
        now = time.perf_counter()
        phase_s[name] = now - marks[-1]
        marks.append(now)
        print(f"chip_smoke phase {name}: {phase_s[name]:.1f} s "
              f"({now - t_start:.1f} s so far)")

    t0 = time.perf_counter()
    _build.load(verbose=True)
    print(f"kernel build and load: {time.perf_counter() - t0:.2f} s")

    k2 = phase_polar_so3(np.random.default_rng(SEED), dev, card)
    k2_100k = phase_polar_so3(np.random.default_rng(SEED + 6), dev, card,
                              n=NUM_NODES * 6400)
    k2_f64 = phase_polar_so3_f64(np.random.default_rng(SEED + 4), dev, card)
    k2_f64_4096 = phase_polar_so3_f64(np.random.default_rng(SEED + 8), dev,
                                      card, n=4096)
    kcond = phase_graph_cond(np.random.default_rng(SEED + 7), dev, card)
    k3 = phase_block_mm(np.random.default_rng(SEED + 9), dev, card)
    lap("kernel phases")
    # The manhattan graph's .g2o file and the CLI's working directory.
    work = tempfile.TemporaryDirectory()

    def make_solver(meas, label, cls=DPGOSolver, init=None,
                    num_nodes=NUM_NODES, **kw):
        t0 = time.perf_counter()
        solver = cls(meas, num_nodes=num_nodes, dtype=torch.float32,
                     device=dev, **kw)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if init is None:
            R0 = chordal_initialization(meas)
            init = (recover_translations_global(meas, R0), R0)
        print(f"{label}: {meas.num_poses} poses, {len(meas)} edges, "
              f"{num_nodes} nodes x {solver.mg.n0_max} poses, d = {meas.d}, "
              f"float32; problem build {t_build:.1f} s, with chordal init "
              f"{time.perf_counter() - t0:.1f} s")
        return solver, init

    paths, launches, k1 = {}, {}, {}
    tp = MMOptions().tnt

    # Path 1: rim_synth, trivial loss (K1 at D = 3, K2).
    rim = read_g2o_file(os.path.join(root, DATASET))
    solver, init = make_solver(rim, f"rim: {DATASET}",
                               opts=MMOptions(accelerated=True))
    # The block-Jacobi preconditioner's share of the build: one Lanczos
    # lambda_max per node on mG11, as build_node_problems runs them.
    mG11 = solver.probs.mG11_d.double().cpu().numpy()
    t0 = time.perf_counter()
    for a in range(NUM_NODES):
        lambda_max_lanczos(mG11[a], seed=a)
    print(f"rim: precon_inv's {NUM_NODES} Lanczos runs on mG11 (host) "
          f"{time.perf_counter() - t0:.2f} s of the problem build")
    del mG11
    st, _ = solver.run_steps(solver.initialize(*init), 0, 3)
    k1["rim"] = phase_stpcg("rim", solver.probs, st, tp, card)
    paths["rim"], launches["rim"], st = run_path(
        "rim", solver, init, ("polar_so3", "stpcg"), card)
    eager_route("rim", solver, init, card, paths["rim"])
    # The estimate the polish path starts from.
    rim_est = tuple(x.double().cpu().numpy()
                    for x in solver.gather_global(st))
    to_profile = [("rim", solver, init)]
    rim_init = init
    del st

    lap("rim")

    # Path 2: 2-D Manhattan world through the EDGE_SE2 reader (K1 at D = 2).
    meas2, t_true, R_true = manhattan_world(
        np.random.default_rng(SEED + 1))
    g2o = os.path.join(work.name, "manhattan.g2o")
    write_g2o_file(g2o, t_true, R_true, meas2)
    meas2 = read_g2o_file(g2o)
    check(meas2.d == 2, "the EDGE_SE2 file did not read back as d = 2")
    solver, init = make_solver(meas2, "manhattan: 2-D Manhattan world "
                               f"(seed {SEED + 1})",
                               opts=MMOptions(accelerated=True))
    st, _ = solver.run_steps(solver.initialize(*init), 0, 3)
    k1["manhattan"] = phase_stpcg("manhattan", solver.probs, st, tp, card)
    # Near the chordal start the preconditioner is close to exact and CG
    # ends after one iteration on every node; from the true rotations turned
    # by N(0, 0.3) rad per pose, at a radius CG stays inside, it runs more.
    rng = np.random.default_rng(SEED + 3)
    th = rng.normal(scale=0.3, size=meas2.num_poses)
    c, s = np.cos(th), np.sin(th)
    turn = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    st = solver.initialize(None, R_true @ turn)
    k1["manhattan_far"] = phase_stpcg("manhattan, far start", solver.probs,
                                      st, tp, card, deltas=(1e4,),
                                      timed=False)
    check(k1["manhattan_far"]["k_max"] > 1, "manhattan: K1 ran no second "
          "CG iteration at the far start")
    paths["manhattan"], launches["manhattan"], _ = run_path(
        "manhattan", solver, init, ("stpcg_d2",), card)
    eager_route("manhattan", solver, init, card, paths["manhattan"])
    to_profile.append(("manhattan", solver, init))
    del st

    lap("manhattan")

    # Path 3: rim_synth with outliers, Huber + dynamic rescale (K1 at D = 3
    # on the reweighted Hred, K2).
    meas3, bad = with_outliers(rim, np.random.default_rng(SEED + 2),
                               NUM_NODES)
    opts3 = MMOptions(accelerated=True, rescale="dynamic")
    solver, init = make_solver(meas3, f"robust: {DATASET} with {len(bad)} "
                               "outlier inter-node edges, Huber, dynamic "
                               "rescale", opts=opts3, loss=Loss.HUBER,
                               loss_reg=LOSS_REG)
    st, _ = solver.run_steps(solver.initialize(*init), 0,
                             opts3.max_rescale_count + 3)
    pw = solver.problems(st)
    check(pw.dynamic and bool((st.scale_w < 1).any()),
          "robust: no rescale before the K1 phase")
    k1["robust"] = phase_stpcg("robust (reweighted Hred)", pw, st, tp,
                               card)
    del pw
    paths["robust"], launches["robust"], st = run_path(
        "robust", solver, init, ("polar_so3", "stpcg"), card)
    sw_min = float(st.scale_w.min())
    t, R = solver.gather_global(st)
    w = loss_weight(Loss.HUBER, edge_sqnorms(solver.edges, t, R), LOSS_REG)
    is_bad = torch.zeros(len(meas3), dtype=torch.bool, device=dev)
    is_bad[torch.as_tensor(bad, device=dev)] = True
    w_out = float(w[is_bad].mean())
    w_in = float(w[solver.edges.is_inter & ~is_bad].mean())
    print(f"robust: min scale_w {sw_min:.4g}; mean final Huber weight "
          f"{w_out:.4g} on the {len(bad)} outliers, {w_in:.4g} on the "
          f"{int((solver.edges.is_inter & ~is_bad).sum())} inlier inter-node "
          "edges")
    check(sw_min < 1.0, "robust: dynamic rescale never fired")
    check(w_out < w_in, f"robust: outlier weight {w_out} not below inlier "
          f"weight {w_in}")
    paths["robust"].update(min_scale_w=sw_min, outlier_weight=w_out,
                           inlier_weight=w_in)
    to_profile.append(("robust", solver, init))
    del st

    lap("robust")

    # Path 4: AMM-PGO* on rim_synth from rim's centralized chordal start.
    solver, _ = make_solver(rim, f"star: {DATASET}, DPGOStarSolver "
                            "(AMM-PGO*)", cls=DPGOStarSolver, init=rim_init,
                            opts=MMOptions(accelerated=True))
    paths["star"], launches["star"], _ = run_path(
        "star", solver, rim_init, ("polar_so3", "stpcg"), card)
    eager_route("star", solver, rim_init, card, paths["star"])
    ratio = paths["star"]["f2_final"] / paths["rim"]["f2_final"]
    print(f"star: final 2f {paths['star']['f2_final']:.6f} against rim's "
          f"AMM-PGO# {paths['rim']['f2_final']:.6f} (ratio {ratio:.6f}; "
          "the two coincide only while no restart triggers)")
    paths["star"]["f2_final_over_rim"] = ratio
    to_profile.append(("star", solver, rim_init))

    lap("star")

    # Path 5: MM-PGO on rim_synth from the CLI's default start, DChordal
    # (K2 in its stages 0 and 2 and in the proximal steps, K1 and K2 in the
    # refinement). First DChordal's stages in float64 (the CLI's default
    # type) from one set-up on the graph route with K2 and with its plain
    # version, and on the host-read route with K2, held to each other;
    # these comparison runs are not counted.
    solver, _ = make_solver(rim, f"mm_dchordal: {DATASET}, MM-PGO from "
                            "DChordal", init=rim_init,
                            opts=MMOptions(accelerated=False))
    edges64 = EdgeData.from_measurements(rim, dtype=torch.float64, device=dev)

    def f2(t, R):
        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=dev)
        return 2.0 * float(evaluate_f(edges64, f(t), f(R)))

    def off_so3(R):
        R = np.asarray(R, np.float64)
        return float(np.abs(np.einsum("nki,nkj->nij", R, R)
                            - np.eye(3)).max())

    def rel(a, b):
        return abs(a - b) / abs(b)

    f_cent = f2(*rim_init)
    routes = (("graph", True, True), ("graph_plain", False, True),
              ("host", True, False))
    r64 = dchordal_routes(rim, torch.float64, dev, card, routes, f2)
    g64, p64, h64 = r64["graph"], r64["graph_plain"], r64["host"]
    f_64, f_64p = g64["f2"], p64["f2"]
    rel64, rel64_host = rel(f_64, f_64p), rel(f_64, h64["f2"])
    print(f"mm_dchordal: DChordal float64 [{card}] graph route 2f "
          f"{f_64:.8f}, host-read route {h64['f2']:.8f} (relative "
          f"difference {rel64_host:.3e}), plain {f_64p:.8f} (relative "
          f"difference {rel64:.3e}); stages {g64['stages_s']:.2f} s graph "
          f"(replay {g64['replay_s']:.3f} s) vs {h64['stages_s']:.2f} s "
          f"host-read; host syncs {g64['host_syncs']} vs "
          f"{h64['host_syncs']}; K2 f64 launches "
          f"{g64['launches']['polar_so3_f64']} vs "
          f"{h64['launches']['polar_so3_f64']}; conditional nodes "
          f"{g64['launches']['graph_cond']}; {f_64 / f_cent:.4f} x the "
          f"centralized chordal 2f {f_cent:.6f}; max |R^T R - I| "
          f"{off_so3(g64['R']):.3e}")
    check(rel64_host <= 1e-8, "mm_dchordal: float64 DChordal graph and "
          f"host-read routes disagree in 2f by {rel64_host} > 1e-8")
    check(rel64 <= 1e-4, f"mm_dchordal: float64 DChordal with K2 and plain "
          f"disagree in 2f by {rel64} > 1e-4")
    check(g64["host_syncs"] == 0 and p64["host_syncs"] == 0,
          "mm_dchordal: the graph route read a flag on the host")
    check(h64["host_syncs"] > 0, "mm_dchordal: the host-read route read "
          "no flag")
    check(g64["launches"]["graph_cond"] > 0
          and p64["launches"]["graph_cond"] > 0,
          "mm_dchordal: the graph route launched no conditional node")
    check(g64["launches"]["polar_so3_f64"] > 0, "mm_dchordal: the float64 "
          f"program did not launch K2: {g64['launches']}")
    check(p64["launches"]["polar_so3_f64"] == 0
          and p64["launches"]["polar_so3"] == 0,
          "mm_dchordal: the plain DChordal launched K2")
    dcfg = DChordalConfig()
    stage_trips = (dcfg.iters_reduced_R, dcfg.iters_full_R,
                   dcfg.iters_reduced_t, dcfg.iters_full_t)
    for r in (g64, p64, h64):
        check(all(r["trips"][n] == [1, t]
                  for n, t in zip(DCHORDAL_LOOPS, stage_trips)),
              f"mm_dchordal: DChordal's stage loops ran {r['trips']}")
    check(off_so3(g64["R"]) <= 1e-12, "mm_dchordal: float64 DChordal "
          "rotation off SO(3)")

    # The path: the solver's own (float32) DChordal through the front door
    # (the graph route), whose launches the path counts. Its float32 stages
    # on the three routes run with the profiles, after every timed run.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solver.initialize(dist_init=True)
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    dc_launches = kernel_counts()
    dc_stats = dict(solver.dchordal_stats)
    t_dc, R_dc = (x.double().cpu().numpy() for x in solver.gather_global(st))
    del st
    check(dc_stats["route"] == "graph" and dc_stats["host_syncs"] == 0,
          f"mm_dchordal: initialize(dist_init=True) took the {dc_stats}")
    check(dc_launches["polar_so3"] > 0, "mm_dchordal: DChordal did not "
          f"launch K2: {dc_launches}")
    check(dc_launches["graph_cond"] > 0, "mm_dchordal: DChordal launched "
          f"no conditional node: {dc_launches}")
    f_dc = f2(t_dc, R_dc)
    orth = off_so3(R_dc)
    print(f"mm_dchordal: DChordal float32 [{card}] {dc_s:.2f} s through "
          f"initialize(dist_init=True) ({dc_stats['route']} route: set-up "
          f"{sum(dc_stats['setup_s'].values()):.2f} s, stages "
          f"{dc_stats['stages_s']:.2f} s, replay {dc_stats['replay_s']:.3f}"
          f" s; launches {dc_launches}); 2f {f_dc:.6f}, "
          f"{f_dc / f_cent:.4f} x the centralized chordal 2f; "
          f"max |R^T R - I| {orth:.3e}")
    check(orth <= 1e-4, f"mm_dchordal: DChordal rotation off SO(3) by {orth}")
    # Reported, not held: on rim the reference's DChordal (the stage
    # lengths of the reference driver) lands above 1.5 x the centralized
    # chordal 2f + 1 even in float64 (PERF.md, section 6), and the float32
    # stage solves are ill-conditioned enough that K2 and its plain version
    # (1e-7 apart per projection) end 1e-1 apart in 2f.
    print(f"mm_dchordal: DChordal within 1.5 x chordal + 1: float32 "
          f"{f_dc <= 1.5 * f_cent + 1.0}, float64 "
          f"{f_64 <= 1.5 * f_cent + 1.0}")
    dc_init = (t_dc, R_dc)
    paths["mm_dchordal"], launches["mm_dchordal"], _ = run_path(
        "mm_dchordal", solver, dc_init, ("polar_so3", "stpcg"), card,
        reset=False, monotone=True)

    def brief(r):
        return {k: v for k, v in r.items() if k not in ("t", "R")}

    paths["mm_dchordal"].update(
        dchordal_s=dc_s, dchordal_stats=dc_stats, dchordal_f2=f_dc,
        chordal_f2=f_cent, dchordal_launches=dc_launches,
        dchordal_f64_f2=f_64, dchordal_f64_plain_f2=f_64p,
        dchordal_routes={"float64": {k: brief(v) for k, v in r64.items()}})
    to_profile.append(("mm_dchordal", solver, dc_init))

    lap("mm_dchordal")

    # Path 6: the CLI, in a temporary working directory.
    here = os.getcwd()
    try:
        os.chdir(work.name)
        for name, argv, rows_want, needs in (
                ("cli_star", ["--dataset", g2o, "--num_nodes",
                              str(NUM_NODES), "--solver", "star",
                              "--dist_init", "true", "--f32", "--iters",
                              "30", "--record_every", "10"], 4,
                 ("stpcg_d2",)),
                ("cli_f64", ["--dataset", os.path.join(
                    root, "artifacts", "grid3D_synth.g2o"), "--num_nodes",
                             "4", "--dist_init", "false", "--iters", "20"],
                 21, ("polar_so3_f64",))):
            reset_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            secs = time.perf_counter() - t0
            launches[name] = kernel_counts()
            nodes = argv[argv.index("--num_nodes") + 1]
            rows = np.loadtxt(f"results_chordal_{nodes}_amm.txt", ndmin=2)
            meas_c = read_g2o_file(argv[1])
            est = np.loadtxt("estimates_trivial.txt", ndmin=2)
            print(f"{name} [{card}]: {secs:.2f} s, {rows.shape[0]} result "
                  f"rows, 2f {rows[0, 2]:.6f} -> {rows[-1, 2]:.6f}, "
                  f"launches {launches[name]}")
            check(rows.shape == (rows_want, 4) and np.isfinite(rows).all(),
                  f"{name}: result rows {rows.shape}")
            check(est.shape == (meas_c.num_poses * (1 + meas_c.d), meas_c.d),
                  f"{name}: estimates shape {est.shape}")
            for kern in needs:
                check(launches[name][kern] > 0, f"{name}: kernel {kern} was "
                      f"not launched: {launches[name]}")
            if name == "cli_star":
                check(bool(np.all(np.diff(rows[:, 2]) <= 0)),
                      f"{name}: 2f rose: {rows[:, 2]}")
            else:
                check(launches[name]["polar_so3"] == 0,
                      f"{name}: the float64 run launched float32 K2")
                check(rows[-1, 2] < rows[0, 2], f"{name}: 2f did not "
                      "decrease")
            paths[name] = {"seconds": secs, "rows": rows.tolist(),
                           "launches": launches[name], "card": card}
    finally:
        os.chdir(here)
    work.cleanup()

    lap("cli")

    # Path 9: PCM, Anderson acceleration and the CLI's --pcm.
    pcm_aa_paths(root, dev, card, make_solver, rim, rim_est, paths,
                 launches, to_profile)

    lap("pcm_aa")

    # Path 8: the global polish and the certificate.
    del solver
    polish_certify_paths(root, dev, card, rim, rim_est, paths, launches)

    lap("polish_certify")

    sesync_rim4096_path(root, dev, card, paths, launches)

    lap("sesync_rim4096")

    # Path 7: node blocks above the dense limit.
    big, big_init = large_block_paths(root, dev, card, make_solver, rim,
                                      paths, launches, to_profile)

    lap("large_blocks")

    # torch.profiler runs only now, after every timed run. The paths above
    # the dense limit make thousands of launches per step, and the profiler
    # takes seconds per thousand: shorter windows there.
    windows = {"rim100k_prox": (50, 10), "rim100k_refined": (20, 3),
               "rim100k_robust": (20, 3), "rim_edgewise": (50, 5)}
    for name, solver, init in to_profile:
        at, steps = windows.get(name, (PROFILE_AT, PROFILE_STEPS))
        paths[name]["profile"] = profile_path(name, solver, init, card, at,
                                              steps)
        if name in EAGER_PATHS:
            prof_e = profile_path(name, solver, init, card, at, steps,
                                  eager=True)
            paths[name]["eager"]["profile"] = prof_e
            g, e = paths[name], paths[name]["eager"]
            pg = g["profile"]
            print(f"{name} graph vs eager route [{card}]: it/s "
                  f"{g['it_s']:.2f} vs {e['it_s']:.2f}; host syncs/step "
                  f"{g['host_syncs_per_step']:.2f} vs "
                  f"{e['host_syncs_per_step']:.2f}; busy share "
                  f"{pg['busy_share']:.3f} vs {prof_e['busy_share']:.3f}; "
                  f"device ms/step {pg['device_ms_per_step']:.3f} vs "
                  f"{prof_e['device_ms_per_step']:.3f}; wall ms/step "
                  f"{pg['wall_ms_per_step']:.3f} vs "
                  f"{prof_e['wall_ms_per_step']:.3f}; capture "
                  f"{g['graph']['capture_s']:.2f} s (+ warm-up "
                  f"{g['graph']['warmup_s']:.2f} s), capture pools "
                  f"{g['graph']['pool_bytes'] / 2**20:.1f} MiB")
    # DChordal's float32 stages from a profiled set-up, with K2 and plain on
    # the graph route and on the host-read route; beside them the solver's
    # own start (mm_dchordal).
    r32 = dchordal_routes(rim, torch.float32, dev, card, routes, f2,
                          profile=True)
    g32, p32, h32 = r32["graph"], r32["graph_plain"], r32["host"]
    check(p32["launches"]["polar_so3"] == 0, "mm_dchordal: the plain "
          "DChordal launched a kernel")
    f_pl = p32["f2"]
    print(f"mm_dchordal: DChordal float32 [{card}] solver's start 2f "
          f"{f_dc:.6f}, plain {f_pl:.6f} (relative difference "
          f"{rel(f_dc, f_pl):.3e}); graph route {g32['f2']:.6f}, host-read "
          f"route {h32['f2']:.6f} (relative difference "
          f"{rel(g32['f2'], h32['f2']):.3e}, not held); "
          f"{f_dc / f_cent:.4f} x the centralized chordal 2f (plain "
          f"{f_pl / f_cent:.4f})")
    paths["mm_dchordal"]["dchordal_plain_f2"] = f_pl
    paths["mm_dchordal"]["dchordal_routes"]["float32"] = {
        k: brief(v) for k, v in r32.items()}
    paths["mm_dchordal"]["dchordal_profile"] = r32["profile"]
    del r32, g32, p32, h32

    # rim's solver stays for the sharded phase's timings, rim100k_prox's for
    # its polish of the split polish's start.
    rim_solver = to_profile[0][1]
    big_solver = next(s for n, s, _ in to_profile if n == "rim100k_prox")
    del to_profile, solver

    lap("profiles")

    # Path 10: the sharded solvers, held to the single-process histories.
    refs = {name: paths[name] for name in ("rim", "star", "rim100k_prox",
                                           "polish_rim", "polish_rim100k")}
    sharded_paths(card, rim, rim_init, rim_est, big, big_init, refs, paths,
                  launches, rim_solver, big_solver)
    del rim_solver, big_solver

    lap("sharded")

    def total(kern):
        return sum(c.get(kern, 0) for c in launches.values())

    def entry(name, source, replaces, stats):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total(name),
                "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                "device_ms": stats["device_ms"],
                "plain_ms": stats["plain_ms"],
                "bound_ms": stats["bound_ms"],
                "bound_by": stats["bound_by"],
                "library_ms": stats["library_ms"],
                "launches_by_path": {p: c.get(name, 0)
                                     for p, c in launches.items()},
                **{k: v for k, v in stats.items() if k == "shapes"}}

    k1_d3 = dict(k1["rim"], max_abs_err=max(k1["rim"]["max_abs_err"],
                                            k1["robust"]["max_abs_err"]))
    k1_d2 = dict(k1["manhattan"], max_abs_err=max(
        k1["manhattan"]["max_abs_err"], k1["manhattan_far"]["max_abs_err"]))
    # K2's float32 entry carries its times at both projection batches.
    k2 = dict(k2, max_abs_err=max(k2["max_abs_err"], k2_100k["max_abs_err"]),
              shapes={"[10240, 3, 3]": k2, "[102400, 3, 3]": k2_100k})
    # So does the float64 one: the rim polish's batch and sesync_rim4096's.
    k2_f64 = dict(k2_f64, max_abs_err=max(k2_f64["max_abs_err"],
                                          k2_f64_4096["max_abs_err"]),
                  shapes={"[10240, 3, 3]": k2_f64,
                          "[4096, 3, 3]": k2_f64_4096})
    kernels = [
        entry("polar_so3", "dpgo_tpu_torch/csrc/polar_so3.cu",
              "dpgo_tpu/ops/pallas_so3.py:70", k2),
        entry("polar_so3_f64", "dpgo_tpu_torch/csrc/polar_so3.cu",
              "dpgo_tpu/ops/pallas_so3.py:70", k2_f64),
        entry("stpcg", "dpgo_tpu_torch/csrc/stpcg.cu",
              "dpgo_tpu/ops/pallas_stpcg.py:140", k1_d3),
        entry("stpcg_d2", "dpgo_tpu_torch/csrc/stpcg.cu",
              "dpgo_tpu/ops/pallas_stpcg.py:140", k1_d2),
        # Not a port of a Pallas kernel: the d x d block products the JAX
        # package leaves to XLA.
        entry("block_mm", "dpgo_tpu_torch/csrc/block_mm.cu", None, k3),
        # Not a port of a Pallas kernel: the flag kernel of the captured
        # step's conditional nodes, the device-side lax.cond / while_loop
        # of the JAX package's one-dispatch step.
        entry("graph_cond", "dpgo_tpu_torch/csrc/graph_cond.cu",
              "dpgo_tpu/driver.py:234", kcond),
    ]
    for p in paths.values():
        p.pop("f2_history", None)
    secs = time.perf_counter() - t_start
    print(f"chip_smoke: whole run {secs:.1f} s [{card}]; phases (s) "
          + ", ".join(f"{n} {t:.1f}" for n, t in phase_s.items()))
    print(json.dumps({"paths": paths, "k1_phases": k1, "seconds": secs,
                      "phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
