"""Dispatch wrappers of the port's kernels, with their launch counters.

Each wrapper checks shapes, dtypes, devices and contiguity, then takes
the plain version (``ref``) only for CPU tensors.  For CUDA tensors it
launches the hand-written kernel or raises: there is no fallback.
``launch_counts[name]`` rises by one at each kernel launch and nowhere
else, so a run can show that it went through the kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .flash_attention import HEAD_DIMS
from .ref import OP_FIELDS, TILE_FIELDS

__all__ = ["dse_eval", "flash_attention", "ssm_scan", "launch_counts",
           "reset_launch_counts"]

launch_counts: Dict[str, int] = {"dse_eval": 0, "flash_attention": 0,
                                 "ssm_scan": 0}

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, H, T, D), equal head counts (the caller
    expands GQA) -> (B, H, S, D) in q's dtype.  Under ``causal`` key j is
    visible to query i iff j <= i + (T - S)."""
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
    if _device_of("flash_attention", q, k, v).type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    from .flash_attention import flash_attention_cuda
    out = flash_attention_cuda(q, k, v, causal)
    launch_counts["flash_attention"] += 1
    return out


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 64
             ) -> torch.Tensor:
    """Mamba2 SSD chunked scan without the D-skip term.  x (B, S, H, P),
    dt (B, S, H) float32, a_log (H,) float32, b/c (B, S, N) of x's dtype
    -> (B, S, H, P) of x's dtype.  The chunk is ``min(chunk, S)`` and must
    divide S, as in the reference."""
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
    if _device_of("ssm_scan", x, dt, a_log, b, c).type == "cpu":
        return ref.ssm_scan_ref(x, dt, a_log, b, c, chunk)
    from .ssm_scan import ssm_scan_cuda
    out = ssm_scan_cuda(x, dt, a_log, b, c, chunk)
    launch_counts["ssm_scan"] += 1
    return out
