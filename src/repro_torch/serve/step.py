"""Serving steps (a port of ``repro/serve/step.py``).

``prefill_step``: run the prompt through the stack writing fresh caches,
return last-token logits + caches.  ``decode_step`` (serve_step): one new
token against the caches.  The steps take the model where the reference
takes its param tree, and run under ``torch.inference_mode()`` (the
model's parameters are trainable; serving records no autograd graph).
Both take the reference's optional ``ctx`` (B, T, d_model), the context
that cross-attention reads: a vision model's image embeddings or an
encoder-decoder's ``encode`` output.
"""
from __future__ import annotations

import torch

from ..models import layers as L
from ..models.config import ModelConfig
from ..models.model import (Model, _context, _embed, _mask_pad_logits,
                            _run_blocks, decode_step as _decode, init_cache)

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.inference_mode()
    def prefill_step(model: Model, tokens: torch.Tensor, ctx=None,
                     caches=None):
        """``caches``: empty caches to fill (``init_cache``'s layout, as
        the dry-run passes them sharded); made here when None.  Caches
        passed in are held to be empty (every attention cache's ``len``
        0; a Mamba cache is overwritten whole) by an assert on the device,
        which reads nothing back to the host."""
        B, S = tokens.shape
        if caches is None:
            caches = init_cache(cfg, B, max_len, model.device)
        else:
            for c in caches:
                if c is not None and "len" in c:
                    torch._assert_async((c["len"] == 0).all(),
                                        "prefill_step: caches not empty")
        x = _embed(model, tokens)
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, caches = _run_blocks(model, x, positions, _context(model, ctx),
                                caches, fresh=True)
        x = L.norm(model.final_norm.scale, x[:, -1:], cfg.norm)
        logits = L.einsum("bsd,dv->bsv", x, model.head())
        return _mask_pad_logits(cfg, logits), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(model: Model, tokens: torch.Tensor, pos: torch.Tensor,
                    caches, ctx=None):
        return _decode(model, tokens, pos, caches, ctx)

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Arg-max of the last position; ties go to the first index, as
    ``jnp.argmax``."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
