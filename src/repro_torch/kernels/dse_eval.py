"""Build and launch the hand-written CUDA ``dse_eval`` kernel.

The source is ``repro_torch/csrc/dse_eval.cu`` (see its header for what
the kernel computes, what bounds it and its tolerance against the plain
version).  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` of the
checkout, named by a digest of the source and flags, and loaded with
``ctypes``.  Pointers and the stream go in as ``c_void_p``.  Nothing is
built when this module is imported.
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

import torch

__all__ = ["build", "build_seconds", "dse_eval_cuda", "SOURCE", "BUILD_DIR",
           "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "dse_eval.cu"
# <checkout>/build/kernels (src/repro_torch -> src -> checkout root)
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_TILE_SLOTS = 64   # shared memory holds 8 candidates x T slots x 40 B


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the dse_eval kernel is built "
                           "with the CUDA toolkit on the GPU machine")
    return found


def build() -> pathlib.Path:
    """Compile the kernel if no library for this source and these flags
    exists yet; returns the library path."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libdse_eval_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.dse_eval_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.dse_eval_launch.restype = ctypes.c_int
    lib.dse_eval_error_string.argtypes = [ctypes.c_int]
    lib.dse_eval_error_string.restype = ctypes.c_char_p
    return lib


def build_seconds() -> float:
    """Build (or find) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def dse_eval_cuda(tiles: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream.  ``tiles`` (B, T, 10) and
    ``ops`` (N, 7) must be contiguous float32 tensors on one CUDA device;
    returns a new (B, N, 2) float32 tensor."""
    B, T, _ = tiles.shape
    N = ops.shape[0]
    if not 1 <= T <= MAX_TILE_SLOTS:
        raise ValueError(f"dse_eval kernel takes 1..{MAX_TILE_SLOTS} tile "
                         f"slots, got {T}")
    if max(B, N) >= 2 ** 31 or B * N >= 2 ** 62:
        raise ValueError(f"dse_eval kernel shape too large: B={B}, N={N}")
    lib = _library()
    out = torch.empty((B, N, 2), dtype=torch.float32, device=tiles.device)
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    rc = lib.dse_eval_launch(tiles.data_ptr(), ops.data_ptr(),
                             out.data_ptr(), B, T, N, stream)
    if rc != 0:
        raise RuntimeError(f"dse_eval launch failed: "
                           f"{lib.dse_eval_error_string(rc).decode()}")
    return out

