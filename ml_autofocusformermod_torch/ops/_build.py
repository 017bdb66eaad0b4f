"""Lazy build of the CUDA kernels in ``ml_autofocusformermod_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface (one entry point per kernel
that returns ``cudaGetLastError()``) and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with ``ctypes``. Nothing is
built when the package is imported: the first CUDA call of any kernel
builds all sources at once, one ``nvcc`` process per source, all started
together. Libraries land in ``csrc/build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. A failed build raises. Processes that start cold
together (the ranks of one host) take turns on a file lock in
``csrc/build/``: the first builds, the others wait and find the libraries
built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build_all", "compile_all", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("cluster_attention", "cluster_attention_bwd",
           "cluster_attention_bwd_saved", "cluster_merge",
           "cluster_merge_bwd", "layer_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use"
        )
    return path


def _target(name: str) -> Path:
    # the shared headers count as part of every source
    src = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    src += (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}.{digest[:16]}.so"


@contextlib.contextmanager
def _locked(path: Path):
    """Hold an exclusive ``flock`` on ``path`` (created if absent)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def compile_all() -> Dict[str, dict]:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together, holding the build directory's lock.

    Returns ``{name: {"seconds": float, "cached": bool, "log": str}}``;
    ``log`` holds nvcc's output, including ``ptxas -v`` register and
    shared-memory counts.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _locked(BUILD_DIR / ".lock"):
        return _compile_missing()


def _compile_missing() -> Dict[str, dict]:
    info: Dict[str, dict] = {}
    procs = {}
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            info[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, target,
        )
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                      "log": log}
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return info


def build_all() -> Dict[str, dict]:
    """Build (or reuse) every kernel library (:func:`compile_all`) and load
    it; returns :func:`compile_all`'s record."""
    info = compile_all()
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]
