"""Launch the hand-written CUDA ``dse_eval`` kernel.

The source is ``repro_torch/csrc/dse_eval.cu`` (see its header for what
the kernel computes, what bounds it and its tolerance against the plain
version).  ``_build`` compiles and loads it at first use; pointers and
the stream go in as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["dse_eval_cuda", "MAX_TILE_SLOTS"]

MAX_TILE_SLOTS = 64   # shared memory holds 8 candidates x T slots x 40 B


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("dse_eval")
    lib.dse_eval_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.dse_eval_launch.restype = ctypes.c_int
    return lib


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
    _build.check(lib, "dse_eval", rc)
    return out
