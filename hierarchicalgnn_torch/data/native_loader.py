"""ctypes binding of the native prefetching event loader (``native/hgnn_io.cc``).

Counterpart of ``hierarchicalgnn_tpu/data/native_loader.py``: C++ worker
threads parse events of a compact binary format into a bounded queue while
the training loop takes them as dicts of numpy arrays (the reference's
16-process torch DataLoader, ``edge_classifier_base.py:41``).

The shared library is built from the checkout's ``native/hgnn_io.cc`` at
first use, with ``native/Makefile``'s flags (``g++ -O3 -std=c++17 -fPIC
-pthread -shared``), into the git-ignored ``build/native/`` directory; its
name carries a hash of the source and flags, so an edited source is
rebuilt.  A failed build or load raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "hgnn_io.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64, 3: np.uint8, 4: np.float64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
                np.dtype(np.int64): 2, np.dtype(np.uint8): 3,
                np.dtype(np.bool_): 3, np.dtype(np.float64): 4}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhgnn_io_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/hgnn_io.cc`` unless an up-to-date library exists;
    returns its path.  Raises if the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/hgnn_io.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


_LOAD_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.hgnn_loader_open.restype = ctypes.c_void_p
    lib.hgnn_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hgnn_loader_next.restype = ctypes.c_void_p
    lib.hgnn_loader_next.argtypes = [ctypes.c_void_p]
    lib.hgnn_loader_close.restype = None
    lib.hgnn_loader_close.argtypes = [ctypes.c_void_p]
    lib.hgnn_event_num_arrays.restype = ctypes.c_int
    lib.hgnn_event_num_arrays.argtypes = [ctypes.c_void_p]
    lib.hgnn_event_name.restype = ctypes.c_char_p
    lib.hgnn_event_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hgnn_event_dtype.restype = ctypes.c_int
    lib.hgnn_event_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hgnn_event_ndim.restype = ctypes.c_int
    lib.hgnn_event_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hgnn_event_dims.restype = ctypes.POINTER(ctypes.c_int64)
    lib.hgnn_event_dims.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hgnn_event_data.restype = ctypes.c_void_p
    lib.hgnn_event_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hgnn_event_free.restype = None
    lib.hgnn_event_free.argtypes = [ctypes.c_void_p]
    lib.hgnn_write_event.restype = ctypes.c_int
    lib.hgnn_write_event.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_void_p)]
    return lib


def write_event(path: str, event: dict):
    """Serialize an event dict to the native binary format (bool as uint8,
    other unsupported dtypes as float32, as the JAX binding does)."""
    lib = library()
    arrays = []
    for k, v in event.items():
        a = np.ascontiguousarray(v)
        if a.dtype == np.bool_:
            a = a.astype(np.uint8)
        if a.dtype not in _DTYPE_CODES:
            a = a.astype(np.float32)
        arrays.append((k, a))
    n = len(arrays)
    names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in arrays])
    dtypes = (ctypes.c_int * n)(*[_DTYPE_CODES[a.dtype] for _, a in arrays])
    ndims = (ctypes.c_int * n)(*[a.ndim for _, a in arrays])
    dims_flat = [d for _, a in arrays for d in a.shape]
    dims = (ctypes.c_int64 * len(dims_flat))(*dims_flat)
    datas = (ctypes.c_void_p * n)(*[a.ctypes.data_as(ctypes.c_void_p) for _, a in arrays])
    if lib.hgnn_write_event(path.encode(), n, names, dtypes, ndims, dims, datas) != 0:
        raise IOError(f"failed to write {path}")


def _event_to_dict(lib, ev_ptr) -> dict:
    out = {}
    for i in range(lib.hgnn_event_num_arrays(ev_ptr)):
        name = lib.hgnn_event_name(ev_ptr, i).decode()
        dtype = np.dtype(_DTYPES[lib.hgnn_event_dtype(ev_ptr, i)])
        ndim = lib.hgnn_event_ndim(ev_ptr, i)
        dims = [lib.hgnn_event_dims(ev_ptr, i)[d] for d in range(ndim)]
        count = int(np.prod(dims)) if dims else 1
        buf = ctypes.cast(lib.hgnn_event_data(ev_ptr, i),
                          ctypes.POINTER(ctypes.c_uint8 * (count * dtype.itemsize)))
        out[name] = np.frombuffer(buf.contents, dtype=dtype).reshape(dims).copy()
    return out


class NativeEventLoader:
    """Iterator over event files with background prefetch threads.

    ``loop=False``: one pass in (seeded) shuffled order (``shuffle_seed``
    -1: file order), then StopIteration.  ``loop=True``: an endless stream,
    reshuffled each epoch with seed + epoch.
    """

    def __init__(self, paths, queue_capacity=8, n_threads=4, shuffle_seed=-1, loop=False):
        self._handle = None
        self._lib = library()
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.hgnn_loader_open(arr, len(self._paths), queue_capacity,
                                                  n_threads, shuffle_seed, int(loop))
        if not self._handle:
            raise RuntimeError("hgnn_loader_open failed")

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if not self._handle:
            raise StopIteration
        ev = self._lib.hgnn_loader_next(self._handle)
        if not ev:
            raise StopIteration
        try:
            return _event_to_dict(self._lib, ev)
        finally:
            self._lib.hgnn_event_free(ev)

    def close(self):
        if self._handle:
            self._lib.hgnn_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
