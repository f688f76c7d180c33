"""Launch the hand-written CUDA ``horner`` kernel.

The source is ``repro_torch/csrc/horner.cu`` (see its header for what the
kernel computes, what bounds it and its tolerance against the plain
version).  ``_build`` compiles and loads it at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["horner_cuda", "MAX_COEFFS"]

MAX_COEFFS = 12288   # the coefficients' shared memory, 48 KB


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("horner")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.horner_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
    lib.horner_launch.restype = ctypes.c_int
    return lib


def horner_cuda(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream.  x (N,) float32 or bfloat16 and coeffs
    (d+1,) float32, contiguous on one CUDA device.  Returns a new (N,)
    tensor of x's dtype."""
    if coeffs.shape[0] > MAX_COEFFS:
        raise ValueError(f"horner takes at most {MAX_COEFFS} coefficients, "
                         f"got {coeffs.shape[0]}")
    lib = _library()
    # y at x's offset from a 16-byte boundary, so that the kernel's vectors
    # line up in both (x may be a view such as x[1:])
    shift = x.data_ptr() % 16 // x.element_size()
    y = torch.empty_like(x) if shift == 0 else torch.empty(
        (x.shape[0] + shift,), dtype=x.dtype, device=x.device)[shift:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.horner_launch(x.data_ptr(), coeffs.data_ptr(), y.data_ptr(),
                           x.shape[0], coeffs.shape[0],
                           int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "horner", rc)
    return y
