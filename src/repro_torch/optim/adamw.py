"""AdamW with optional 8-bit block-quantized moments (a port of
``repro/optim/adamw.py``).

``moments_dtype="int8"`` stores both moments as int8 with a float32
scale per block (the trailing dim), a quarter of the float32 moments'
memory.  The parameters are a model's; gradients and moments are dicts
keyed by parameter name (its ``named_parameters()`` order); the optimizer
state is ``{"mu": {name: {"m": ..., "v": ...}}, "step": int32 scalar}``,
with ``{"q": int8, "scale": float32}`` for each int8 moment.

Every step runs in float32 in the reference's operation order: the
global-norm clip, the moments, the bias corrections, ``upd + wd * p``
and the cast back to the parameter's dtype.  The port updates the
parameters and moments in place (the reference returns new arrays): the
train state holds one copy of each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn

__all__ = ["AdamWConfig", "init_opt_state", "apply_updates"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "fp32"  # "fp32" | "int8"


def _q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-12
    return {"q": torch.round(x / scale).to(torch.int8),
            "scale": scale.to(F32)}


def _dq8(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    return q["q"].to(F32) * q["scale"]


def init_opt_state(model: nn.Module, cfg: AdamWConfig) -> Dict:
    def one(p):
        zeros = torch.zeros(p.shape, dtype=F32, device=p.device)
        if cfg.moments_dtype == "int8":
            return {"m": _q8(zeros), "v": _q8(zeros)}
        return {"m": zeros, "v": torch.zeros_like(zeros)}

    ps = dict(model.named_parameters())
    dev = next(iter(ps.values())).device
    return {"mu": {name: one(p) for name, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def apply_updates(model: nn.Module, grads: Mapping[str, torch.Tensor],
                  opt_state: Dict, cfg: AdamWConfig, lr_scale=1.0
                  ) -> Tuple[nn.Module, Dict, torch.Tensor]:
    """One AdamW step.  Returns (model, opt_state, grad_norm): the same
    parameters and moments, updated in place, and the float32 global
    gradient norm before clipping."""
    ps = dict(model.named_parameters())
    step = opt_state["step"] + 1
    gnorm = torch.sqrt(sum(torch.sum(grads[n].to(F32) ** 2) for n in ps))
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32, device=t.device)
    int8 = cfg.moments_dtype == "int8"
    for name, p in ps.items():
        mu = opt_state["mu"][name]
        g = grads[name].to(F32) * clip
        m = _dq8(mu["m"]) if int8 else mu["m"]
        v = _dq8(mu["v"]) if int8 else mu["v"]
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * upd).to(p.dtype))
        if int8:
            mu["m"], mu["v"] = _q8(m), _q8(v)
        else:
            mu["m"].copy_(m)
            mu["v"].copy_(v)
    opt_state["step"] = step
    return model, opt_state, gnorm
