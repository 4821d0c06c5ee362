"""Seconds of the problem build: the host clock around the solver's
constructor (problem.build_node_problems), ending in a synchronize."""

LAYER = "Problem build"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.spans["build_s"]
