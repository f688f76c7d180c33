"""Launch the hand-written CUDA ``ssm_scan`` kernel.

The source is ``repro_torch/csrc/ssm_scan.cu`` (see its header for what
the kernel computes, what bounds it and its tolerance against the plain
version).  ``_build`` compiles and loads it at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ssm_scan_cuda"]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Launch on the current stream.  x (B, S, H, P) and b, c (B, S, N) of
    one dtype (float32 or bfloat16), dt (B, S, H) and a_log (H,) float32,
    all contiguous on one CUDA device, S a multiple of ``chunk``.  Returns
    a new (B, S, H, P) tensor of x's dtype."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    if B * S * H * P >= 2 ** 62 or B * H >= 2 ** 31:
        raise ValueError(f"ssm_scan shape too large: {tuple(x.shape)}")
    lib = _library()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "ssm_scan", rc)
    return y
