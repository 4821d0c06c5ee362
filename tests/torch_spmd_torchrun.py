"""One rank of a sharded solve started by torchrun, for
tests/test_torch_spmd.py (imports torch and the port only):

    torchrun --standalone --nproc-per-node 2 tests/torch_spmd_torchrun.py \
        GRAPH.g2o NUM_NODES STEPS OUT

joins the group torchrun describes (gloo, on the CPU), runs AMM-PGO# with
the boundary exchange and writes OUT.<rank>.json: rank, world size,
backend, device and the 2f history."""

import json
import sys

import torch
import torch.distributed as dist


def main():
    from dpgo_tpu_torch.io.g2o import read_g2o_file
    from dpgo_tpu_torch.parallel import ShardedDPGOSolver
    from dpgo_tpu_torch.parallel.launch import init_from_env

    torch.set_num_threads(1)
    path, num_nodes, steps, out = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    rank, world_size, dev = init_from_env("gloo", device="cpu")
    try:
        s = ShardedDPGOSolver(read_g2o_file(path), num_nodes, device=dev)
        _, _, (f, _) = s.run_steps_history(s.initialize(), 0, steps)
        with open(f"{out}.{rank}.json", "w") as fh:
            json.dump({"rank": rank, "world_size": world_size,
                       "backend": s.comm.backend, "device": str(dev),
                       "f2": f.tolist()}, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
