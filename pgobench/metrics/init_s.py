"""Seconds of the start: the host clock around DPGOSolver.initialize (the
centralized chordal start on the host, sesync/init.py, and the first
update), ending in a synchronize."""

LAYER = "Initialization"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.spans["init_s"]
