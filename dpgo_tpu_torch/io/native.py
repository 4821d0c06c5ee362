"""ctypes bindings for the native host runtime (torch port of
dpgo_tpu/io/native.py): the g2o parser and the max-clique solver of
`native/g2o_reader.cpp` and `native/max_clique.cpp`.

The library is built at first use from those two sources into the port's
own build directory, beside the CUDA kernels (`ops/_build.py`):

    g++ -O3 -fPIC -std=c++17 -shared \
        -o build/dpgo_tpu_torch/libdpgo_native.so \
        native/g2o_reader.cpp native/max_clique.cpp

It is rebuilt when the hash of the sources changes. The build runs under a
file lock and writes a temporary name that is then renamed into place, so
concurrent processes never load a half-written file; `make` in `native/`
is never run. Without a C++ compiler `read_g2o_file_native` falls back to
the Python parser and `max_clique_native` returns None (the callers then
use the Python clique solvers, as the JAX package does).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from dpgo_tpu_torch.io.g2o import Measurements, read_g2o_file as _py_read
from dpgo_tpu_torch.ops._build import BUILD_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = tuple(os.path.join(_REPO, "native", f)
                for f in ("g2o_reader.cpp", "max_clique.cpp"))
LIB_PATH = os.path.join(BUILD_DIR, "libdpgo_native.so")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


class _Loaded:
    """The loaded library (set once per process); `failed` holds the reason
    the build or load failed, if it did."""

    lib = None
    failed: str | None = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(CXXFLAGS).encode())
    return h.hexdigest()


def build() -> str:
    """Compile the library if it is missing or stale; returns its path."""
    digest = _source_hash()
    stamp = LIB_PATH + ".sha256"

    def fresh() -> bool:
        if not (os.path.exists(LIB_PATH) and os.path.exists(stamp)):
            return False
        with open(stamp) as fh:
            return fh.read().strip() == digest

    if fresh():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():  # another process built it while this one waited
            return LIB_PATH
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, os.path.basename(LIB_PATH))
            subprocess.run([cxx, *CXXFLAGS, "-o", out, *SOURCES], check=True,
                           capture_output=True)
            os.replace(out, LIB_PATH)
        with open(stamp + ".tmp", "w") as fh:
            fh.write(digest)
        os.replace(stamp + ".tmp", stamp)
    return LIB_PATH


def _load():
    if _Loaded.lib is not None or _Loaded.failed is not None:
        return _Loaded.lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError) as exc:
        _Loaded.failed = f"{type(exc).__name__}: {exc}"
        return None
    lib.dpgo_parse_g2o.restype = ctypes.c_void_p
    lib.dpgo_parse_g2o.argtypes = [ctypes.c_char_p]
    lib.dpgo_error.restype = ctypes.c_char_p
    lib.dpgo_error.argtypes = [ctypes.c_void_p]
    lib.dpgo_num_edges.restype = ctypes.c_int64
    lib.dpgo_num_edges.argtypes = [ctypes.c_void_p]
    lib.dpgo_num_poses.restype = ctypes.c_int64
    lib.dpgo_num_poses.argtypes = [ctypes.c_void_p]
    lib.dpgo_dim.restype = ctypes.c_int
    lib.dpgo_dim.argtypes = [ctypes.c_void_p]
    lib.dpgo_copy.restype = None
    lib.dpgo_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.dpgo_free.restype = None
    lib.dpgo_free.argtypes = [ctypes.c_void_p]
    lib.dpgo_max_clique.restype = ctypes.c_int64
    lib.dpgo_max_clique.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_void_p]
    _Loaded.lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def max_clique_native(adj: np.ndarray, exact: bool = True
                      ) -> np.ndarray | None:
    """Maximum clique of a boolean adjacency matrix via the native solver
    (the reference's fmc library role). Returns the membership mask, or None
    when the native library is unavailable (callers fall back to the Python
    implementation in pcm.py)."""
    lib = _load()
    if lib is None:
        return None
    n = adj.shape[0]
    a = np.ascontiguousarray(adj, dtype=np.uint8)
    out = np.zeros(n, np.uint8)
    lib.dpgo_max_clique(a.ctypes.data_as(ctypes.c_void_p), n,
                        1 if exact else 0,
                        out.ctypes.data_as(ctypes.c_void_p))
    return out.astype(bool)


def read_g2o_file_native(filename: str) -> Measurements:
    """Parse via the native library; falls back to the Python parser."""
    lib = _load()
    if lib is None:
        return _py_read(filename)
    h = lib.dpgo_parse_g2o(filename.encode())
    try:
        err = lib.dpgo_error(h)
        if err:
            raise ValueError(f"native g2o parse failed: {err.decode()}")
        m = lib.dpgo_num_edges(h)
        d = lib.dpgo_dim(h)
        P = lib.dpgo_num_poses(h)
        i = np.empty(m, np.int64)
        j = np.empty(m, np.int64)
        R = np.empty((m, d, d), np.float64)
        t = np.empty((m, d), np.float64)
        kappa = np.empty(m, np.float64)
        tau = np.empty(m, np.float64)
        lib.dpgo_copy(
            h, i.ctypes.data_as(ctypes.c_void_p),
            j.ctypes.data_as(ctypes.c_void_p),
            R.ctypes.data_as(ctypes.c_void_p),
            t.ctypes.data_as(ctypes.c_void_p),
            kappa.ctypes.data_as(ctypes.c_void_p),
            tau.ctypes.data_as(ctypes.c_void_p))
        return Measurements(i=i, j=j, R=R, t=t, kappa=kappa, tau=tau,
                            num_poses=int(P), d=d)
    finally:
        lib.dpgo_free(h)
