"""Launch the hand-written CUDA ``ssm_scan`` kernels (forward and
backward).

The sources are ``repro_torch/csrc/ssm_scan.cu`` (the forward) and
``repro_torch/csrc/ssm_scan_bwd.cu`` (the backward), with the stages they
share in ``repro_torch/csrc/ssm_tc.cuh``; see their headers for what each
computes, what bounds it and its tolerance against the plain version.
bfloat16 runs on the tensor cores as chunk-parallel stages, float32 on the
CUDA cores; both cut a chunk into tiles of at most 64 rows and take any
chunk that divides S.  The bfloat16 kernels are instantiated for P in
``TC_HEAD_DIMS`` and N in ``TC_STATES``; any other P or N runs as groups
of at most 64 columns and 128 states, each zero-padded to the next
instantiated width (``split_scan``, ``split_scan_bwd``).  ``_build``
compiles and loads them at first use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ops import launch_counts

__all__ = ["ssm_scan_cuda", "ssm_scan_bwd_cuda", "split_scan",
           "split_scan_bwd", "tc_launches", "TC_HEAD_DIMS", "TC_STATES"]

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


def _p_groups(P: int):
    """P as the bf16 kernels run it: groups of at most 64 columns, each
    zero-padded to the next of ``TC_HEAD_DIMS``; (p0, p1, width) each."""
    out = []
    for p0 in range(0, P, TC_HEAD_DIMS[-1]):
        p1 = min(P, p0 + TC_HEAD_DIMS[-1])
        out.append((p0, p1, next(w for w in TC_HEAD_DIMS if w >= p1 - p0)))
    return out


def _n_groups(N: int):
    """N as the bf16 kernels run it: groups of at most 128 states, each
    zero-padded to the next of ``TC_STATES``; (n0, n1, width) each."""
    out = []
    for n0 in range(0, N, TC_STATES[-1]):
        n1 = min(N, n0 + TC_STATES[-1])
        out.append((n0, n1, next(w for w in TC_STATES if w >= n1 - n0)))
    return out


def tc_launches(P: int, N: int) -> int:
    """Kernel launches of one bf16 scan (forward or backward) at head dim
    P and state width N: one per (P group, N group)."""
    return len(_p_groups(P)) * len(_n_groups(N))


def _cols(t: torch.Tensor, lo: int, hi: int, width: int) -> torch.Tensor:
    """``t[..., lo:hi]`` zero-padded to ``width`` columns, contiguous."""
    t = t[..., lo:hi]
    if width != hi - lo:
        return torch.nn.functional.pad(t, (0, width - (hi - lo)))
    return t.contiguous()


def _tc_args(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
             *aligned: torch.Tensor):
    """The bf16 kernels' launch plan: the P groups and N groups
    (``_p_groups``, ``_n_groups``) and the number of 64-row tiles of one
    (batch, head).  Any P and N run; the tensors must be aligned for
    TMA."""
    if any(t.data_ptr() % 16 for t in (x, b, c, *aligned)):
        raise ValueError("ssm_scan: bfloat16 tensors must start on a "
                         "16-byte boundary (TMA)")
    return (_p_groups(x.shape[-1]), _n_groups(b.shape[-1]),
            _n_tiles(x.shape[1], chunk))


def _split(pg, ng, P: int) -> bool:
    """Whether the plan cuts P or N (else one launch at the given P)."""
    return len(pg) > 1 or len(ng) > 1 or pg[0][2] != P


def split_scan(fwd, x, dt, a_log, b, c, chunk: int) -> torch.Tensor:
    """The scan at any P and N from ``fwd`` (``ssm_scan``'s signature)
    called on the bf16 kernels' groups.  The heads' columns are
    independent, so y is the P groups' outputs side by side; y sums over
    the states, so the N groups' outputs add in float32 and round once
    more to x's dtype.  Zero-padded columns add nothing."""
    ys = []
    for p0, p1, pw in _p_groups(x.shape[-1]):
        xg, y = _cols(x, p0, p1, pw), None
        for n0, n1, nw in _n_groups(b.shape[-1]):
            yg = fwd(xg, dt, a_log, _cols(b, n0, n1, nw),
                     _cols(c, n0, n1, nw), chunk)
            y = yg if y is None else y.float() + yg.float()
        ys.append(y[..., :p1 - p0].to(x.dtype))
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)


def split_scan_bwd(bwd, x, dt, a_log, b, c, dy, chunk: int):
    """The gradients (dx, ddt, da_log, db, dc) at any P and N from ``bwd``
    called on the bf16 kernels' groups: ``bwd(x, dt, a_log, b, c, dy,
    chunk, acc)`` returns (dx, ddt) and adds d a_log, db and dc into the
    float32 accumulators ``acc`` = (da (H,), db (B, S, n), dc (B, S, n)).
    The P groups of one N group share its accumulators, so db and dc are
    cast once; dx sums over the N groups and ddt over every group, in
    float32."""
    B, S, H, P = x.shape
    f32, dev = torch.float32, x.device
    da = torch.zeros((H,), dtype=f32, device=dev)
    pg = _p_groups(P)
    xs = [_cols(x, p0, p1, pw) for p0, p1, pw in pg]
    dys = [_cols(dy, p0, p1, pw) for p0, p1, pw in pg]
    dx, ddt, db, dc = [None] * len(pg), None, [], []
    for n0, n1, nw in _n_groups(b.shape[-1]):
        acc = (da, torch.zeros((B, S, nw), dtype=f32, device=dev),
               torch.zeros((B, S, nw), dtype=f32, device=dev))
        bg, cg = _cols(b, n0, n1, nw), _cols(c, n0, n1, nw)
        for i, (p0, p1, _) in enumerate(pg):
            dxg, ddtg = bwd(xs[i], dt, a_log, bg, cg, dys[i], chunk, acc)
            dxg = dxg[..., :p1 - p0]
            dx[i] = dxg if dx[i] is None else dx[i].float() + dxg.float()
            ddt = ddtg.float() if ddt is None else ddt + ddtg.float()
        db.append(acc[1][..., :n1 - n0])
        dc.append(acc[2][..., :n1 - n0])
    dx = torch.cat([d.to(x.dtype) for d in dx], dim=-1)
    return (dx, ddt.to(dt.dtype), da.to(a_log.dtype),
            torch.cat(db, dim=-1).to(b.dtype),
            torch.cat(dc, dim=-1).to(c.dtype))


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Launch on the current stream.  x (B, S, H, P) and b, c (B, S, N) of
    one dtype (float32 or bfloat16), dt (B, S, H) and a_log (H,) float32,
    all contiguous on one CUDA device, S a multiple of ``chunk``.  Returns
    a new (B, S, H, P) tensor of x's dtype.  In bfloat16 a P or N the
    kernels do not instantiate runs as ``tc_launches`` launches
    (``split_scan``)."""
    _check_size(x)
    if x.dtype == torch.bfloat16:
        pg, ng, _ = _tc_args(x, b, c, chunk)
        if _split(pg, ng, x.shape[-1]):
            return split_scan(_launch_fwd, x, dt, a_log, b, c, chunk)
        width = ng[0][2]
        b, c = (_cols(t, 0, t.shape[-1], width) for t in (b, c))
    return _launch_fwd(x, dt, a_log, b, c, chunk)


def _launch_fwd(x, dt, a_log, b, c, chunk: int) -> torch.Tensor:
    """One forward launch, counted in ``ops.launch_counts``; in bfloat16
    at P in ``TC_HEAD_DIMS`` and N in ``TC_STATES``."""
    B, S, H, P = x.shape
    lib = _library()
    y = torch.empty_like(x)
    states = decay = None
    if x.dtype == torch.bfloat16:
        nt = _n_tiles(S, chunk)
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
    launch_counts["ssm_scan"] += 1
    return y


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      chunk: int):
    """Launch the backward on the current stream: the forward's inputs (as
    ``ssm_scan_cuda`` takes them) and the output gradient ``dy`` (as x).
    Returns new (dx, ddt, da_log, db, dc), each of its input's dtype.  The
    kernels sum db, dc over the heads and d a_log over the batch with
    float32 atomics; in bfloat16 a P or N the kernels do not instantiate
    runs as ``tc_launches`` launches (``split_scan_bwd``)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    _check_size(x)
    f32, dev = torch.float32, x.device
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        pg, ng, _ = _tc_args(x, b, c, chunk, dy)
        if _split(pg, ng, P):
            return split_scan_bwd(_bwd_group, x, dt, a_log, b, c, dy, chunk)
        b, c = (_cols(t, 0, N, ng[0][2]) for t in (b, c))
    width = b.shape[-1]
    da = torch.zeros((H,), dtype=f32, device=dev)
    # db and dc are summed over the heads by atomics, in float32
    db_acc = torch.zeros((B, S, width), dtype=f32, device=dev)
    dc_acc = torch.zeros((B, S, width), dtype=f32, device=dev)
    db, dc = (torch.empty_like(b), torch.empty_like(c)) if bf16 else (
        db_acc, dc_acc)
    dx, ddt = _launch_bwd(x, dt, a_log, b, c, dy, chunk, da, db_acc, dc_acc,
                          db, dc)
    if width != N:
        db, dc = db[..., :N].contiguous(), dc[..., :N].contiguous()
    return dx, ddt, da, db, dc


def _bwd_group(x, dt, a_log, b, c, dy, chunk: int, acc):
    """``split_scan_bwd``'s group: one bf16 launch adding into the shared
    float32 accumulators ``acc`` (its own bf16 casts of them are
    scratch)."""
    da, db_acc, dc_acc = acc
    return _launch_bwd(x, dt, a_log, b, c, dy, chunk, da, db_acc, dc_acc,
                       torch.empty_like(b), torch.empty_like(c))


def _launch_bwd(x, dt, a_log, b, c, dy, chunk: int, da, db_acc, dc_acc, db,
                dc):
    """One backward launch, counted in ``ops.launch_counts``, adding into
    ``da``, ``db_acc``, ``dc_acc``; returns (dx, ddt).  In bfloat16 at P in ``TC_HEAD_DIMS`` and N in
    ``TC_STATES``, casting the accumulators into ``db``, ``dc``."""
    B, S, H, P = x.shape
    lib = _bwd_library()
    f32, dev = torch.float32, x.device
    bf16 = x.dtype == torch.bfloat16
    width = b.shape[-1]
    d_states = decay = None
    if bf16:
        nt = _n_tiles(S, chunk)
        # the state entering each tile, and the gradient of the state
        # leaving it
        states, d_states = (torch.empty((B * H, nt, P, width), dtype=f32,
                                        device=dev) for _ in range(2))
        decay = torch.empty((B * H, nt), dtype=f32, device=dev)
    else:
        states = torch.empty((B * H, _n_tiles(S, chunk), P, width),
                             dtype=f32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssm_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        da.data_ptr(), db.data_ptr(), dc.data_ptr(), db_acc.data_ptr(),
        dc_acc.data_ptr(), states.data_ptr(), _ptr(d_states), _ptr(decay),
        B, S, H, P, width, chunk, int(bf16), stream)
    _build.check(lib, "ssm_scan_bwd", rc)
    launch_counts["ssm_scan_bwd"] += 1
    return dx, ddt
