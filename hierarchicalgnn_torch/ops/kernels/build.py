"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``),
at first use, into the git-ignored ``build/kernels/`` directory beside the
package.  A library's name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing here runs
at import time: a CPU-only host imports the module without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: name -> argument types (all return int,
# the launch's cudaGetLastError()).
SIGNATURES = {
    "segment_csr.cu": {
        "hgnn_csr_sum_bf16": (_P, _P, _P, _I, _I, _P),
        "hgnn_csr_sum_f32": (_P, _P, _P, _I, _I, _P),
        "hgnn_csr_wsum_bf16": (_P, _P, _P, _P, _I, _I, _P),
        "hgnn_csr_wsum_f32": (_P, _P, _P, _P, _I, _I, _P),
        "hgnn_csr_min_i32": (_P, _P, _P, _I, _P),
    },
}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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


@functools.cache
def library(source: str = "segment_csr.cu") -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build_all((source,))
    lib = ctypes.CDLL(str(library_path(source)))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
