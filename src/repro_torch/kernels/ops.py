"""Dispatch wrappers of the port's kernels, with their launch counters.

``dse_eval(tiles, ops)`` takes the plain version (``ref.dse_eval_ref``)
only for CPU tensors.  For CUDA tensors it launches the hand-written
kernel or raises: there is no fallback.  ``launch_counts["dse_eval"]``
rises by one at each kernel launch and nowhere else, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .ref import OP_FIELDS, TILE_FIELDS

__all__ = ["dse_eval", "launch_counts", "reset_launch_counts"]

launch_counts: Dict[str, int] = {"dse_eval": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
    if tiles.device != ops.device:
        raise ValueError(f"tiles on {tiles.device}, ops on {ops.device}")
    if not (tiles.is_contiguous() and ops.is_contiguous()):
        raise ValueError("dse_eval takes contiguous tensors")
    if tiles.device.type == "cpu":
        return ref.dse_eval_ref(tiles, ops)
    if tiles.device.type != "cuda":
        raise ValueError(f"dse_eval runs on cpu or cuda, not {tiles.device}")
    from .dse_eval import dse_eval_cuda
    out = dse_eval_cuda(tiles, ops)
    launch_counts["dse_eval"] += 1
    return out
