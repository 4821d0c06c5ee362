"""Seconds of the start's global estimate (DPGOSolver._start: the
centralized chordal initialization and the translation recovery, host
SuperLU): the host seconds of the program's span "init.chordal". None
where the program keeps no spans."""

from pgobench import spans

LAYER = "Initialization"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return spans.host_s("init.chordal")
