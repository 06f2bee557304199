"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``),
at first use, into the git-ignored ``build/kernels/`` directory beside the
package.  A library's name carries a hash of its source, the headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  Nothing here runs
at import time: a CPU-only host imports the module without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
# C signature of every entry point: name -> argument types (all return int,
# the launch's cudaGetLastError()).
SIGNATURES = {
    "segment_csr.cu": {
        # (data, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes, stream)
        "hgnn_csr_sum_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "hgnn_csr_sum_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # (data, w, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes, stream)
        "hgnn_csr_wsum_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "hgnn_csr_wsum_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # (vals, recv, row_ptr, out, arrivals, mins, n_edges, n_rows, tile, stream)
        "hgnn_csr_min_i32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    "sddmm_csr.cu": {
        # (data, rows, recv, row_ptr, out, n_edges, n_rows, d, stream)
        "hgnn_sddmm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
        "hgnn_sddmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
        # (scale or NULL, rows, recv, row_ptr, out, n_edges, n_rows, d, stream)
        "hgnn_scaled_gather_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
        "hgnn_scaled_gather_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    "segment_gather.cu": {
        # (data, perm, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes,
        #  width, stream)
        "hgnn_csr_gather_sum_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "hgnn_csr_gather_sum_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "ring_gather.cu": {
        # (n_launches, devices[], streams[], rank0s[], n_locals[], n_ranks, flags[],
        #  error, held[], handle[1])
        "hgnn_k8_layout": (_I, _P, _P, _P, _P, _I, _P, _P, _P, _P),
        # (layout)
        "hgnn_k8_layout_free": (_P,),
        # (layout, plan[], in[], out[], block_bytes, generation, target, timeout_ns,
        #  issued[1])
        "hgnn_ring_all_gather": (_P, _P, _P, _P, _L, _U, _U, _U, _P),
        # (layout, generation, n_launches, wait)
        "hgnn_k8_ended": (_P, _U, _I, _I),
        # (device, peer)
        "hgnn_enable_peer_access": (_I, _I),
    },
    "top2.cu": {
        # (a, prices, out[3, n_rows], n_rows, n_cols, warps_per_row, grid, stream)
        "hgnn_row_top2_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "knn_select.cu": {
        # (dots, sq_q, sq_p, valid, out_d2, out_idx, n_rows, n_cols, k, staged, idx_bits,
        #  smem, stream)
        "hgnn_knn_select_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "hdbscan.cu": {
        # (x, out, part, arrivals, n, d, k, slices, stream)
        "hgnn_core_distances_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        # (smem, info[3])
        "hgnn_prim_mst_cluster_size": (_I, ctypes.POINTER(_I)),
        # (x, core, src, dst, dist, n, d, ctas, points, per_thread, smem, stream)
        "hgnn_prim_mst_cluster_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # (x, core, src, dst, dist, cand, barrier, n, d, grid, points, smem, stream)
        "hgnn_prim_mst_f64": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def included_headers(source: str) -> list[Path]:
    """The headers of ``csrc/`` that ``source`` includes, directly or through
    another header, in the order they are first met."""
    found, todo = [], [CSRC_DIR / source]
    while todo:
        text = todo.pop(0).read_text()
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M):
            path = CSRC_DIR / name
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(source: str) -> Path:
    """The library of ``source``: its name carries a hash of the source, of
    the headers it includes and of the flags, so a change to any of them
    builds a new one."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in included_headers(source):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:12]}.so"


def build_all(sources=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every source that has no up-to-date library, one nvcc each,
    all started together.  Returns {source: compiler output} (ptxas's
    register and spill report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    reports, failed = {}, []
    for source, (proc, tmp, out) in procs.items():
        reports[source] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{source}:\n{reports[source]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


_LOAD_LOCK = threading.Lock()


def library(source: str = "segment_csr.cu") -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed (once, also
    when several threads ask at the same time)."""
    with _LOAD_LOCK:
        return _load(source)


@functools.cache
def _load(source: str) -> ctypes.CDLL:
    build_all((source,))
    lib = ctypes.CDLL(str(library_path(source)))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
