"""Training step: loss -> grads -> AdamW, with optional gradient
accumulation over microbatches and rematerialised layers (a port of
``repro/train/step.py``).

The train state is ``{"params": Model, "opt": AdamW state, "step": int32
scalar}``; the step updates the model's parameters and the moments in
place.  Gradients are taken with ``torch.autograd.grad`` of ``loss_fn``;
on the card the attention and Mamba2 layers run their forward and
backward kernels.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..distributed.sharding import is_dtensor
from ..models.config import ModelConfig
from ..models.model import Model, loss_fn
from ..optim.adamw import AdamWConfig, apply_updates, init_opt_state
from ..optim.schedule import warmup_cosine

__all__ = ["TrainState", "init_train_state", "make_grads_fn",
           "make_train_step"]

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def init_train_state(cfg: ModelConfig, params: Model, opt_cfg: AdamWConfig
                     ) -> TrainState:
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params.device)}


def make_grads_fn(cfg: ModelConfig, microbatches: int = 1,
                  remat: bool = True):
    """Returns grads_of(model, batch) -> (loss, {name: grad}).

    ``microbatches`` > 1 splits the batch along its first axis and sums
    the slices' losses and gradients in float32, then scales by
    1 / microbatches (the reference's ``lax.scan`` accumulation)."""

    def one(model: Model, names, params, mb):
        with torch.enable_grad():
            loss = loss_fn(model, mb, remat=remat)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach (the norm2 of a block
        # without an FFN) has a zero gradient, as in the reference
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def grads_of(model: Model, batch: Dict[str, torch.Tensor]):
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            loss, grads = one(model, names, params, batch)
            return loss, dict(zip(names, grads))
        mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                            + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]
        for i in range(microbatches):
            loss, grads = one(model, names, params,
                              {k: _laid_out_as(v[i], batch[k])
                               for k, v in mbs.items()})
            loss_sum = loss_sum + loss
            gsum = [a + g for a, g in zip(gsum, grads)]
            del grads
        inv = 1.0 / microbatches
        return loss_sum * inv, {n: g * inv for n, g in zip(names, gsum)}

    return grads_of


def _laid_out_as(part: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A microbatch of a DTensor batch, sharded as the batch was (its
    split gathers the batch axis; each slice is then cut again, a local
    slice, so every device keeps its share of the rows)."""
    if not is_dtensor(whole):
        return part
    return part.redistribute(whole.device_mesh, whole.placements)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, remat: bool = True,
                    warmup: int = 200, total_steps: int = 10000):
    """Returns train_step(state, batch) -> (state, metrics): the gradients
    of ``make_grads_fn`` (``microbatches`` slices), the warmup-cosine
    scale of the step, and one AdamW update in place."""
    grads_of = make_grads_fn(cfg, microbatches, remat)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = grads_of(state["params"], batch)
        lr_scale = warmup_cosine(state["step"], warmup, total_steps)
        _, opt, gnorm = apply_updates(state["params"], grads, state["opt"],
                                      opt_cfg, lr_scale)
        del grads
        new_state = {"params": state["params"], "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "lr_scale": lr_scale}

    return train_step
