"""pgobench: the benchmark of dpgo_tpu_torch, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json` once. Everything a cell needs
is data under this folder, found by name: a configuration's file
(`configs/`), a solver mix (`mixes/`), the cell's steps per solve and
limits (`cells/`), and one reader per per-layer metric (`metrics/`). The
yardstick lives here too: the graph generators (`gen/`), the plain float64
reference (`reference/`), the kernels' work from shapes (`roofline.py`)
and the reading of the trace (`trace.py`).
"""
