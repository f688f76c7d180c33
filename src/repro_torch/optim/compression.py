"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (a port of ``repro/optim/compression.py``).

Quantizing the gradient to int8 with a per-tensor scale halves the bf16
all-reduce's bytes; error feedback keeps the quantization residual
locally so that the compression is unbiased over time (EF-SGD).  The
gradient trees are dicts of tensors keyed by parameter name.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_compress_tree",
           "init_error_state"]

Tree = Dict[str, torch.Tensor]


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    return torch.round(g / scale).to(torch.int8), scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: Tree, error_state: Tree
                     ) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                                Tree]:
    """Compress a gradient tree with error feedback.  Returns ({name:
    (q, scale)}, new error state); the caller all-reduces the int8 payload
    and decompresses after the collective."""
    comp, new_err = {}, {}
    for name, g in grads.items():
        corrected = g.to(torch.float32) + error_state[name]
        q, s = compress_int8(corrected)
        comp[name] = (q, s)
        new_err[name] = corrected - decompress_int8(q, s)
    return comp, new_err


def init_error_state(grads_like: Tree) -> Tree:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}
