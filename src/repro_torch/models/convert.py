"""Carry the reference's weights across: the param tree of
``repro.models.model.init_params``, with numpy arrays as leaves, becomes
the port's ``Model``.

The copy is bitwise.  A JAX bf16 array turns into a numpy array of the
``ml_dtypes`` type ``bfloat16``, which ``torch.from_numpy`` refuses and
which this package does not import: such an array is recognised by its
dtype's name, read as ``uint16`` bits and viewed as ``torch.bfloat16``.

Layer ``i = r * len(pattern) + j`` of the port takes row ``r`` of every
leaf of ``tree["blocks"][j]`` (the reference stacks the repeats of each
pattern position on a leading axis).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .model import Model

__all__ = ["to_torch", "params_from_jax", "layer_index"]


def to_torch(a) -> torch.Tensor:
    """A numpy array (bf16 of ``ml_dtypes`` included) as a CPU tensor of
    the same dtype and bits."""
    a = np.array(a, order="C")     # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def layer_index(cfg: ModelConfig, j: int, r: int) -> int:
    """The port's layer for pattern position ``j`` of repeat ``r``."""
    return r * len(cfg.pattern()) + j


def _leaves(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device=None
                    ) -> Model:
    """Build the port's model for ``cfg`` on ``device`` from the
    reference's param tree.  Every leaf must find a parameter of the same
    shape and dtype, and every parameter a leaf."""
    model = Model(cfg, device=device, generator=None)
    src: Dict[str, Any] = {}
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            src.update(_leaves(tree[key], key))
    for j, block in enumerate(tree["blocks"]):
        for name, leaf in _leaves(block, ""):
            leaf = np.asarray(leaf)
            for r in range(cfg.n_repeats):
                src[f"layers.{layer_index(cfg, j, r)}.{name}"] = leaf[r]
    extra = set(tree) - {"embed", "final_norm", "lm_head", "blocks"}
    params = dict(model.named_parameters())
    if extra or set(src) != set(params):
        raise ValueError(
            f"param tree and model differ: tree only "
            f"{sorted(set(src) - set(params)) + sorted(extra)}, model only "
            f"{sorted(set(params) - set(src))}")
    with torch.no_grad():
        for name, p in params.items():
            t = to_torch(src[name])
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: tree has {tuple(t.shape)} "
                                 f"{t.dtype}, model {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(t)
    return model
