"""Launch the hand-written CUDA ``ssm_scan`` kernels (forward and
backward).

The sources are ``repro_torch/csrc/ssm_scan.cu`` (the forward) and
``repro_torch/csrc/ssm_scan_bwd.cu`` (the backward), with the stages they
share in ``repro_torch/csrc/ssm_tc.cuh``; see their headers for what each
computes, what bounds it and its tolerance against the plain version.
bfloat16 runs on the tensor cores as chunk-parallel stages, float32 on the
CUDA cores; both cut a chunk into tiles of at most 64 rows and take any
chunk that divides S.  The bfloat16 kernels take P in ``TC_HEAD_DIMS`` and
a state width N of at most ``TC_STATES[-1]`` (zero-padded here to the next
of ``TC_STATES``), and raise otherwise.  ``_build`` compiles and loads
them at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ssm_scan_cuda", "ssm_scan_bwd_cuda", "TC_HEAD_DIMS",
           "TC_STATES"]

TC_HEAD_DIMS = (16, 32, 64)        # the bf16 kernels' instantiations of P
TC_STATES = (16, 32, 64, 128)      # ... and of N
TILE_ROWS = 64                     # a chunk's tiles, in both dtypes


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_bwd_launch.argtypes = [p] * 16 + [i] * 7 + [p]
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_size(x: torch.Tensor) -> None:
    B, S, H, P = x.shape
    if B * S * H * P >= 2 ** 62 or B * H >= 2 ** 31:
        raise ValueError(f"ssm_scan shape too large: {tuple(x.shape)}")


def _n_tiles(S: int, chunk: int) -> int:
    """The tiles of one (batch, head): ceil(chunk / 64) a chunk."""
    return (S // chunk) * -(-chunk // TILE_ROWS)


def _tc_args(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
             *aligned: torch.Tensor):
    """The bf16 kernels' limits; returns b, c zero-padded to the state
    width they run (the padded columns add nothing to y and get no
    gradient) and the number of 64-row tiles of one (batch, head)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    if P not in TC_HEAD_DIMS or N > TC_STATES[-1]:
        raise ValueError(
            f"ssm_scan in bfloat16 takes P in {TC_HEAD_DIMS} and N <= "
            f"{TC_STATES[-1]}; got P={P}, N={N}")
    width = next(n for n in TC_STATES if n >= N)
    if width != N:
        b, c = (torch.nn.functional.pad(t, (0, width - N)) for t in (b, c))
    if any(t.data_ptr() % 16 for t in (x, b, c, *aligned)):
        raise ValueError("ssm_scan: bfloat16 tensors must start on a "
                         "16-byte boundary (TMA)")
    return b, c, _n_tiles(S, chunk)


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Launch on the current stream.  x (B, S, H, P) and b, c (B, S, N) of
    one dtype (float32 or bfloat16), dt (B, S, H) and a_log (H,) float32,
    all contiguous on one CUDA device, S a multiple of ``chunk``.  Returns
    a new (B, S, H, P) tensor of x's dtype."""
    B, S, H, P = x.shape
    _check_size(x)
    lib = _library()
    y = torch.empty_like(x)
    states = decay = None
    if x.dtype == torch.bfloat16:
        b, c, nt = _tc_args(x, b, c, chunk)
        # the chunk states, then the state entering each tile (in place)
        states = torch.empty((B * H, nt, P, b.shape[-1]), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((B * H, nt), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), _ptr(states), _ptr(decay), B, S, H, P,
        b.shape[-1], chunk, int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "ssm_scan", rc)
    return y


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      chunk: int):
    """Launch the backward on the current stream: the forward's inputs (as
    ``ssm_scan_cuda`` takes them) and the output gradient ``dy`` (as x).
    Returns new (dx, ddt, da_log, db, dc), each of its input's dtype.  The
    kernels sum db, dc over the heads and d a_log over the batch with
    float32 atomics."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    _check_size(x)
    lib = _bwd_library()
    f32, dev = torch.float32, x.device
    bf16 = x.dtype == torch.bfloat16
    d_states = decay = None
    if bf16:
        b, c, nt = _tc_args(x, b, c, chunk, dy)
        # the state entering each tile, and the gradient of the state
        # leaving it
        states, d_states = (torch.empty((B * H, nt, P, b.shape[-1]),
                                        dtype=f32, device=dev)
                            for _ in range(2))
        decay = torch.empty((B * H, nt), dtype=f32, device=dev)
    else:
        states = torch.empty((B * H, _n_tiles(S, chunk), P, N), dtype=f32,
                             device=dev)
    width = b.shape[-1]
    dx = torch.empty_like(x)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    da = torch.zeros((H,), dtype=f32, device=dev)
    # db and dc are summed over the heads by atomics, in float32
    db_acc = torch.zeros((B, S, width), dtype=f32, device=dev)
    dc_acc = torch.zeros((B, S, width), dtype=f32, device=dev)
    db, dc = (torch.empty_like(b), torch.empty_like(c)) if bf16 else (
        db_acc, dc_acc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssm_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        da.data_ptr(), db.data_ptr(), dc.data_ptr(), db_acc.data_ptr(),
        dc_acc.data_ptr(), states.data_ptr(), _ptr(d_states), _ptr(decay),
        B, S, H, P, width, chunk, int(bf16), stream)
    _build.check(lib, "ssm_scan_bwd", rc)
    if width != N:
        db, dc = db[..., :N].contiguous(), dc[..., :N].contiguous()
    return dx, ddt, da, db, dc
