"""Seconds of the problem build's assembly (problem.build_node_problems:
the np.add.at loops over the nodes and the dense operator images) on the
host: the host seconds of the program's span "build.assemble". None
where the program keeps no spans."""

from pgobench import spans

LAYER = "Problem build"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return spans.host_s("build.assemble")
