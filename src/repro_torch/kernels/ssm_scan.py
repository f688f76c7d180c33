"""Launch the hand-written CUDA ``ssm_scan`` kernels (forward and
backward).

The sources are ``repro_torch/csrc/ssm_scan.cu`` (the forward) and
``repro_torch/csrc/ssm_scan_bwd.cu`` (the backward); see their headers for
what each computes, what bounds it and its tolerance against the plain
version.  ``_build`` compiles and loads them at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ssm_scan_cuda", "ssm_scan_bwd_cuda"]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_bwd_launch.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int
    return lib


def _check_size(x: torch.Tensor) -> None:
    B, S, H, P = x.shape
    if B * S * H * P >= 2 ** 62 or B * H >= 2 ** 31:
        raise ValueError(f"ssm_scan shape too large: {tuple(x.shape)}")


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Launch on the current stream.  x (B, S, H, P) and b, c (B, S, N) of
    one dtype (float32 or bfloat16), dt (B, S, H) and a_log (H,) float32,
    all contiguous on one CUDA device, S a multiple of ``chunk``.  Returns
    a new (B, S, H, P) tensor of x's dtype."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    _check_size(x)
    lib = _library()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "ssm_scan", rc)
    return y


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      chunk: int):
    """Launch the backward on the current stream: the forward's inputs (as
    ``ssm_scan_cuda`` takes them) and the output gradient ``dy`` (as x).
    Returns new (dx, ddt, da_log, db, dc), each of its input's dtype.  The
    kernel sums db, dc over the heads and d a_log over the batch with
    float32 atomics."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    _check_size(x)
    lib = _bwd_library()
    f32, dev = torch.float32, x.device
    dx = torch.empty_like(x)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    da = torch.zeros((H,), dtype=f32, device=dev)
    # db and dc are summed over the heads by atomics, in float32
    db_acc = torch.zeros((B, S, N), dtype=f32, device=dev)
    dc_acc = torch.zeros((B, S, N), dtype=f32, device=dev)
    db, dc = (db_acc, dc_acc) if b.dtype == f32 else (
        torch.empty_like(b), torch.empty_like(c))
    states = torch.empty((B * H, S // chunk, P, N), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssm_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        da.data_ptr(), db.data_ptr(), dc.data_ptr(), db_acc.data_ptr(),
        dc_acc.data_ptr(), states.data_ptr(), B, S, H, P, N, chunk,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "ssm_scan_bwd", rc)
    return dx, ddt, da, db, dc
