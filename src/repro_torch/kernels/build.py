"""Build the hand-written CUDA kernels and load them through ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes). Libraries land in ``build/kernels/``
at the repository root, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. All stale
libraries build in parallel, one ``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module of
the port, and the CPU container has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: one library per source; the names are the C entry points' modules
SOURCES = {
    "decode_attention": "decode_attention.cu",
    "flash_attention": "flash_attention.cu",
}
HEADERS = ("attn_common.cuh",)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per library
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    cands = [os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every stale library (in parallel). Returns seconds per
    library built (empty when all were current). Raises with nvcc's
    output when a compile fails."""
    names = list(names or SOURCES)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    secs = {}
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n} (exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib
