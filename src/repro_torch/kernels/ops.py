"""Dispatch wrappers of the port's kernels, with their launch counters.

Each wrapper checks shapes, dtypes, devices and contiguity, then takes
the plain version (``ref``) only for CPU tensors.  For CUDA tensors it
launches the hand-written kernel or raises: there is no fallback.
``launch_counts[name]`` rises by one at each kernel launch and nowhere
else, so a run can show that it went through the kernel; the scans'
launchers (``ssm_scan._launch_fwd``, ``_launch_bwd``) add theirs, one a
launch, so a bf16 scan that runs in groups counts each group.

``flash_attention`` and ``ssm_scan`` are differentiable.  On CPU tensors
autograd runs through the plain version.  On CUDA tensors that need a
gradient they go through a ``torch.autograd.Function`` whose forward is
the forward kernel and whose backward is the backward kernel
(``flash_attention_bwd``, ``ssm_scan_bwd``); without a gradient
(serving, under ``torch.inference_mode()``) only the forward kernel
runs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ref
from .flash_attention import HEAD_DIMS
from .ref import OP_FIELDS, TILE_FIELDS

__all__ = ["dse_eval", "flash_attention", "flash_attention_bwd", "ssm_scan",
           "ssm_scan_bwd", "horner", "launch_counts", "reset_launch_counts"]

launch_counts: Dict[str, int] = {
    "dse_eval": 0, "flash_attention": 0, "flash_attention_bwd": 0,
    "ssm_scan": 0, "ssm_scan_bwd": 0, "horner": 0}

_FLOATS = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _device_of(name: str, *ts: torch.Tensor) -> torch.device:
    """The one device (cpu or cuda) of contiguous tensors; raises
    otherwise."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in ts})}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def dse_eval(tiles: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """(B, T, 10) tiles x (N, 7) ops -> (B, N, 2) [best seconds, energy]."""
    if tiles.dim() != 3 or tiles.shape[-1] != TILE_FIELDS:
        raise ValueError(f"tiles must be (B, T, {TILE_FIELDS}), got "
                         f"{tuple(tiles.shape)}")
    if ops.dim() != 2 or ops.shape[-1] != OP_FIELDS:
        raise ValueError(f"ops must be (N, {OP_FIELDS}), got "
                         f"{tuple(ops.shape)}")
    if tiles.dtype != torch.float32 or ops.dtype != torch.float32:
        raise TypeError(f"dse_eval takes float32, got {tiles.dtype} / "
                        f"{ops.dtype}")
    if _device_of("dse_eval", tiles, ops).type == "cpu":
        return ref.dse_eval_ref(tiles, ops)
    from .dse_eval import dse_eval_cuda
    out = dse_eval_cuda(tiles, ops)
    launch_counts["dse_eval"] += 1
    return out


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.device:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B,H,S,D) and k, v "
                         f"(B,H,T,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {_FLOATS}, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")
    if q.shape[3] not in HEAD_DIMS or k.shape[2] == 0:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS} and "
                         f"T >= 1, got D={q.shape[3]}, T={k.shape[2]}")
    return _device_of("flash_attention", q, k, v)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (also writing the row log-sum-exp) and the
    backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from .flash_attention import flash_attention_cuda
        out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        launch_counts["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, H, T, D), equal head counts (the caller
    expands GQA) -> (B, H, S, D) in q's dtype.  Under ``causal`` key j is
    visible to query i iff j <= i + (T - S).  Differentiable."""
    if _check_flash(q, k, v).type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    from .flash_attention import flash_attention_cuda
    out = flash_attention_cuda(q, k, v, causal)
    launch_counts["flash_attention"] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: Optional[torch.Tensor],
                        dout: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv), in q's dtype, of ``flash_attention``
    at (q, k, v) for the output gradient ``dout``.  ``out`` and ``lse``
    ((B, H, S) float32 row log-sum-exp of the scaled scores) are the
    forward kernel's; the plain version (CPU tensors) recomputes both and
    takes the gradients by autograd."""
    dev = _check_flash(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be as q {tuple(q.shape)} "
                         f"{q.dtype}")
    if dev.type == "cpu":
        _device_of("flash_attention_bwd", q, out, dout)
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ref.flash_attention_ref(*qkv, causal)
            return torch.autograd.grad(o, qkv, dout)
    if lse is None or lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd takes the forward's float32 "
                         f"lse of shape {tuple(q.shape[:3])}")
    _device_of("flash_attention_bwd", q, out, lse, dout)
    from .flash_attention import flash_attention_bwd_cuda
    grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    launch_counts["flash_attention_bwd"] += 1
    return grads


def _check_ssm(x, dt, a_log, b, c, chunk: int) -> Tuple[torch.device, int]:
    if x.dim() != 4 or b.dim() != 3 or b.shape != c.shape \
            or b.shape[:2] != x.shape[:2] or dt.shape != x.shape[:3] \
            or a_log.shape != (x.shape[2],):
        raise ValueError(f"ssm_scan takes x (B,S,H,P), dt (B,S,H), a_log "
                         f"(H,), b, c (B,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if x.dtype not in _FLOATS or b.dtype != x.dtype or c.dtype != x.dtype \
            or dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"ssm_scan takes x, b, c of one of {_FLOATS} and "
                        f"float32 dt, a_log; got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}, {dt.dtype}, {a_log.dtype}")
    S = x.shape[1]
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssm_scan: chunk {chunk} does not divide S={S}")
    return _device_of("ssm_scan", x, dt, a_log, b, c), chunk


class _SsmScan(torch.autograd.Function):
    """The forward kernel and the backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk):
        from .ssm_scan import ssm_scan_cuda
        y = ssm_scan_cuda(x, dt, a_log, b, c, chunk)
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a_log, b, c = ctx.saved_tensors
        return (*ssm_scan_bwd(x, dt, a_log, b, c, dy.contiguous(),
                              ctx.chunk), None)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128
             ) -> torch.Tensor:
    """Mamba2 SSD chunked scan without the D-skip term.  x (B, S, H, P),
    dt (B, S, H) float32, a_log (H,) float32, b/c (B, S, N) of x's dtype
    -> (B, S, H, P) of x's dtype.  The chunk is ``min(chunk, S)`` and must
    divide S, as in the reference, whose entry point
    (``repro/kernels/ops.py::ssm_scan``) defaults to 128 too.
    Differentiable."""
    dev, chunk = _check_ssm(x, dt, a_log, b, c, chunk)
    if dev.type == "cpu":
        return ref.ssm_scan_ref(x, dt, a_log, b, c, chunk)
    if _needs_grad(x, dt, a_log, b, c):
        return _SsmScan.apply(x, dt, a_log, b, c, chunk)
    from .ssm_scan import ssm_scan_cuda
    return ssm_scan_cuda(x, dt, a_log, b, c, chunk)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, da_log, db, dc) of ``ssm_scan`` at its
    inputs for the output gradient ``dy`` (as x), each of its input's
    dtype.  The plain version (CPU tensors) takes them by autograd of
    ``ref.ssm_scan_ref``."""
    dev, chunk = _check_ssm(x, dt, a_log, b, c, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must be as x {tuple(x.shape)} {x.dtype}")
    _device_of("ssm_scan_bwd", x, dy)
    if dev.type == "cpu":
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
            y = ref.ssm_scan_ref(*ins, chunk)
            return torch.autograd.grad(y, ins, dy)
    from .ssm_scan import ssm_scan_bwd_cuda
    return ssm_scan_bwd_cuda(x, dt, a_log, b, c, dy, chunk)


def horner(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] x^i by Horner's rule, elementwise.  x (N,) float32
    or bfloat16; coeffs (d+1,) float32, lowest degree first.  Computes in
    float32 and returns x's dtype (as ``ops.horner`` of the reference,
    the Pallas kernel's entry point, does)."""
    if x.dim() != 1 or coeffs.dim() != 1 or coeffs.shape[0] < 1:
        raise ValueError(f"horner takes x (N,) and coeffs (d+1,), got "
                         f"{tuple(x.shape)}, {tuple(coeffs.shape)}")
    if x.dtype not in _FLOATS or coeffs.dtype != torch.float32:
        raise TypeError(f"horner takes x of one of {_FLOATS} and float32 "
                        f"coeffs, got {x.dtype}, {coeffs.dtype}")
    if _device_of("horner", x, coeffs).type == "cpu":
        return ref.horner_ref(x, coeffs)
    from .horner import horner_cuda
    out = horner_cuda(x, coeffs)
    launch_counts["horner"] += 1
    return out
