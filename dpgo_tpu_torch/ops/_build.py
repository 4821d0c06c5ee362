"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` source is compiled by its own nvcc process, all started
together, and the objects are linked into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
         -Xcompiler -fPIC -o <name>.o csrc/<name>.cu        # one per source
    nvcc -shared -o build/dpgo_tpu_torch/libdpgo_kernels.so *.o

The library lands in `build/dpgo_tpu_torch/` at the repository root (listed
in .gitignore) and is rebuilt when the hash of the sources changes. Nothing
here runs at import time: `load()` is called by the kernel wrappers on their
first launch, and again cheaply after that.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

from dpgo_tpu_torch.utils import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "dpgo_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libdpgo_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point (all return cudaError_t as int).
_SIGNATURES = {
    # (A, a batch / row / column strides, B, its strides, C, n, d, dtype,
    #  mv, int64 counter, bool live, stream)
    "dpgo_block_mm": [_P, ctypes.c_longlong, _I, _I, _P, ctypes.c_longlong,
                      _I, _I, _P, ctypes.c_longlong, _I, _I, _I, _P, _P, _P],
    # (A, R, n, stream), float32 and float64
    "dpgo_polar_so3": [_P, _P, ctypes.c_longlong, _P],
    "dpgo_polar_so3_f64": [_P, _P, ctypes.c_longlong, _P],
    # (H, P, g, v0, Q, S, Delta, active, h, Hh, norm, k, N, nd, d, cluster,
    #  max_iters, kappa_fgr, theta, stream)
    "dpgo_stpcg": [_P] * 12 + [_I] * 5 + [_F, _F, _P],
    # (nd, d, cluster, int* resident clusters)
    "dpgo_stpcg_clusters": [_I, _I, _I, _P],
    # Conditional graph nodes (graph_nodes.py): (parent stream, child
    # stream, flag, kind, handle out); (handle, flag, stream); (child stream)
    "dpgo_cond_begin": [_P, _P, _P, _I, _P],
    "dpgo_cond_set": [ctypes.c_ulonglong, _P, _P],
    "dpgo_cond_end": [_P],
    # (stream, int* types out, capacity, int* count out)
    "dpgo_capture_node_types": [_P, _P, _I, _P],
}


class _Loaded:
    """The loaded library (set once per process)."""

    lib = None


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dpgo_tpu_torch are built at first use and need "
                           "the CUDA toolkit")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; returns their joined output, or raises
    with the output of one that failed once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + log)
    return "".join(logs)


def _compile(verbose: bool) -> None:
    """Every source to an object by its own nvcc, side by side, then the
    objects to the library, renamed into place."""
    nvcc = _nvcc()
    ptxas = ["--ptxas-options=-v"] if verbose else []
    srcs = [s for s in sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in srcs]
        log = _run_all([[nvcc, *ARCH_FLAGS, *ptxas, "-std=c++17", "-O3",
                         "-c", "-Xcompiler", "-fPIC", "-lineinfo", "-o",
                         o, s] for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, os.path.basename(LIB_PATH))
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
    if verbose:
        print(log)


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. The check and the build run under a file lock on the build
    directory, so ranks that start together compile once; the library and
    its stamp are renamed into place, so no process loads a half-written
    file."""
    digest = source_hash()
    stamp = LIB_PATH + ".sha256"

    def fresh() -> bool:
        if not (os.path.exists(LIB_PATH) and os.path.exists(stamp)):
            return False
        with open(stamp) as fh:
            return fh.read().strip() == digest

    if fresh():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():  # another process built it while this one waited
            return LIB_PATH
        with span("kernels.build", setup=True):
            _compile(verbose)
        with open(stamp + ".tmp", "w") as fh:
            fh.write(digest)
        os.replace(stamp + ".tmp", stamp)
    return LIB_PATH


def load(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process
    (spans "kernels.load" and, where nvcc runs, "kernels.build")."""
    if _Loaded.lib is None:
        with span("kernels.load", setup=True):
            lib = ctypes.CDLL(build(verbose))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _Loaded.lib = lib
    return _Loaded.lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

