"""bf16 arithmetic as the reference computes it.

The JAX package's tests and its CPU runs see XLA's CPU backend, where
every primitive on bf16 rounds its result to bf16 and a bf16 dot widens
its operands to float32, sums, and rounds once.  A port that wants the
reference's bits (and with them the same MoE routing decisions, which a
one-bit difference upstream can flip) writes the activations as the
reference's primitives and contracts bf16 the same way.
"""
from __future__ import annotations

import math

import torch

__all__ = ["einsum", "silu", "gelu_tanh"]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded to ``like``'s dtype first, as JAX's weak
    types do (PyTorch would multiply by it in float32)."""
    return torch.tensor(v, dtype=torch.float32,
                        device=like.device).to(like.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * logistic(x), which XLA expands into
    1 / (1 + exp(-x)), each primitive rounding on bf16 as each PyTorch op
    on a bf16 tensor does (F.silu rounds once, and differs in the last
    bf16 bit of about one element in five)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    inner = _const(math.sqrt(2 / math.pi), x) \
        * (x + _const(0.044715, x) * (x * (x * x)))
    return x * (_const(0.5, x) * (1.0 + torch.tanh(inner)))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """An einsum of bf16 operands with float32 accumulation, rounded once
    to their dtype.  On the CPU the operands are widened first: that is
    how XLA's CPU backend lowers a bf16 dot, and it gives the reference's
    bits, where PyTorch's bf16 CPU kernel sums in another order.  On the
    card cuBLAS takes the bf16 operands and accumulates in float32."""
    if ops[0].device.type == "cpu" and ops[0].dtype == torch.bfloat16:
        return torch.einsum(eq, *(o.float() for o in ops)).to(ops[0].dtype)
    return torch.einsum(eq, *ops)
