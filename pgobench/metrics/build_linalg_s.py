"""Seconds of the problem build's dense linear algebra on the host
(problem.build_node_problems: eigh and the split inverse, the
reduced-operator products, the Lanczos runs, the dense and block-Jacobi
inverses): the host seconds of the program's span "build.linalg". None
where the program keeps no spans."""

from pgobench import spans

LAYER = "Problem build"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return spans.host_s("build.linalg")
