from dpgo_tpu_torch.parallel.spmd import (HaloSchedule, ShardedDPGOSolver,
                                          ShardedDPGOStarSolver,
                                          build_halo_schedule)

__all__ = ["ShardedDPGOSolver", "ShardedDPGOStarSolver", "HaloSchedule",
           "build_halo_schedule"]
