"""Launch the hand-written CUDA ``flash_attention`` kernel.

The source is ``repro_torch/csrc/flash_attention.cu`` (see its header for
what the kernel computes, what bounds it and its tolerance against the
plain version).  ``_build`` compiles and loads it at first use.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention_cuda", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           ctypes.c_float, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """Launch on the current stream.  q (B, H, S, D), k and v (B, H, T, D):
    contiguous, one dtype (float32 or bfloat16), one CUDA device, D in
    ``HEAD_DIMS``.  Returns a new (B, H, S, D) tensor of q's dtype."""
    B, H, S, D = q.shape
    T = k.shape[2]
    if max(B * H, S, T) >= 2 ** 31 or B * H * max(S, T) * D >= 2 ** 62:
        raise ValueError(f"flash_attention shape too large: {q.shape}, "
                         f"T={T}")
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S,
        T, D, int(causal), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(D), stream)
    _build.check(lib, "flash_attention", rc)
    return out
