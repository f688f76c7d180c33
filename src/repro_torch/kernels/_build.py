"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``repro_torch/csrc/`` with a plain C
interface (the headers there, ``*.cuh``, are shared).  At first use
``nvcc`` compiles it for ``sm_90a`` into a shared library under
``build/kernels/`` of the checkout, named by the kernel and a digest of
its source, the headers and the flags, and ``ctypes`` loads it; what
``nvcc`` printed (``ptxas -v``: registers, spills and shared memory of
each kernel) is kept beside it (``build_log``).  ``build_all`` starts one
``nvcc`` per source at once and waits for all.  Nothing is built when
this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KERNELS", "source", "build_all",
           "library", "library_path", "build_log", "check"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
# <checkout>/build/kernels (src/repro_torch -> src -> checkout root)
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("dse_eval", "flash_attention", "flash_attention_bwd", "ssm_scan",
           "ssm_scan_bwd", "horner")


def source(name: str) -> pathlib.Path:
    return _PKG / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit on the GPU machine")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``name`` is (or will be) built."""
    h = hashlib.sha256(source(name).read_bytes())
    for hdr in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``name`` ('' if no log was
    kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that has no library for its source and
    flags yet, one ``nvcc`` each, all started together.  Returns the
    seconds from the start until each library existed (0 for one that
    was already built)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            secs[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[name] = (cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}:\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
        secs[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel's library.  Each library
    exports ``<name>_error_string(int) -> const char*`` beside its
    launch functions, whose argument types the caller sets."""
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch function returned another code than
    ``cudaSuccess``."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
