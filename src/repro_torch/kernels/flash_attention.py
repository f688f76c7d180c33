"""Launch the hand-written CUDA ``flash_attention`` kernels (forward and
backward).

The sources are ``repro_torch/csrc/flash_attention.cu`` (the forward) and
``repro_torch/csrc/flash_attention_bwd.cu`` (the backward); see their
headers for what each computes, what bounds it and its tolerance against
the plain version.  bfloat16 runs on the tensor cores (wgmma on tiles
that TMA brings in, ``csrc/hopper_tc.cuh``), float32 on the CUDA cores.
``_build`` compiles and loads them at first use.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           f, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 6 + [
        ctypes.c_float, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def _check_size(q: torch.Tensor, T: int) -> None:
    B, H, S, D = q.shape
    if max(B * H, S, T) >= 2 ** 31 or B * H * max(S, T) * D >= 2 ** 62:
        raise ValueError(f"flash_attention shape too large: {q.shape}, "
                         f"T={T}")


def _check_aligned(*ts: torch.Tensor) -> None:
    """The bf16 kernels read their inputs by TMA, which takes 16-byte
    aligned base addresses."""
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention: bfloat16 tensors must start on "
                         "a 16-byte boundary (TMA)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, with_lse: bool = False):
    """Launch on the current stream.  q (B, H, S, D), k and v (B, H, T, D):
    contiguous, one dtype (float32 or bfloat16), one CUDA device, D in
    ``HEAD_DIMS``.  Returns a new (B, H, S, D) tensor of q's dtype, and
    with ``with_lse`` also the (B, H, S) float32 row log-sum-exp of the
    scaled scores (for the backward)."""
    B, H, S, D = q.shape
    T = k.shape[2]
    _check_size(q, T)
    _check_aligned(q, k, v)
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B * H, S, T, D, int(causal),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D), stream)
    _build.check(lib, "flash_attention", rc)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool):
    """Launch the backward on the current stream: the forward's inputs,
    its output ``out`` and row log-sum-exp ``lse``, and the output
    gradient ``dout`` (contiguous, as ``out``).  Returns new (dq, dk, dv)
    of the inputs' shapes and dtype."""
    B, H, S, D = q.shape
    T = k.shape[2]
    _check_size(q, T)
    _check_aligned(q, k, v, dout)
    lib = _bwd_library()
    # dq is summed over the key tiles by atomics, in float32
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(), B * H, S, T, D,
        int(causal), int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
        stream)
    _build.check(lib, "flash_attention_bwd", rc)
    return dq, dk, dv
