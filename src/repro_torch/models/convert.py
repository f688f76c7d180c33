"""Carry the reference's weights across: the param tree of
``repro.models.model.init_params``, with numpy arrays as leaves, becomes
the port's ``Model``.

The copy is bitwise.  A JAX bf16 array turns into a numpy array of the
``ml_dtypes`` type ``bfloat16``, which ``torch.from_numpy`` refuses and
which this package does not import: such an array is recognised by its
dtype's name, read as ``uint16`` bits and viewed as ``torch.bfloat16``.

The reference's ``prefix`` list (the ``first_k_dense`` layers, not
stacked) gives the port's first layers; then layer
``first_k_dense + r * len(pattern) + j`` takes row ``r`` of every leaf
of ``tree["blocks"][j]`` (the reference stacks the repeats of each
pattern position on a leading axis), and encoder layer ``i`` row ``i``
of ``tree["encoder"]``.  ``opt_state_from_jax`` applies the same mapping
to the reference's AdamW state, whose ``mu`` tree holds, at each
parameter's path, ``{"m", "v"}`` (float32) or their int8 form ``{"q",
"scale"}``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..optim.adamw import AdamWConfig, init_opt_state
from .config import ModelConfig
from .model import Model

__all__ = ["to_torch", "params_from_jax", "opt_state_from_jax",
           "layer_index"]


def to_torch(a) -> torch.Tensor:
    """A numpy array (bf16 of ``ml_dtypes`` included) as a CPU tensor of
    the same dtype and bits."""
    a = np.array(a, order="C")     # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def layer_index(cfg: ModelConfig, j: int, r: int) -> int:
    """The port's layer for pattern position ``j`` of repeat ``r``."""
    return cfg.first_k_dense + r * len(cfg.pattern()) + j


def _leaves(tree: Any, prefix: str,
            is_leaf: Callable[[Any], bool]) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict) and not is_leaf(tree):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k, is_leaf)
    else:
        yield prefix, tree


def _row(leaf: Any, r: int) -> Any:
    if isinstance(leaf, dict):
        return {k: _row(v, r) for k, v in leaf.items()}
    return np.asarray(leaf)[r]


def _by_port_name(cfg: ModelConfig, tree: Dict[str, Any], names,
                  is_leaf: Callable[[Any], bool]) -> Dict[str, Any]:
    """The reference tree's leaves keyed by the port's parameter names;
    raises unless they are exactly ``names``."""
    src: Dict[str, Any] = {}
    top = ("embed", "final_norm", "lm_head", "enc_final_norm")
    for key in top:
        if key in tree:
            src.update(_leaves(tree[key], key, is_leaf))
    for j, layer in enumerate(tree.get("prefix", [])):
        src.update(_leaves(layer, f"layers.{j}", is_leaf))
    for j, block in enumerate(tree["blocks"]):
        for name, leaf in _leaves(block, "", is_leaf):
            for r in range(cfg.n_repeats):
                src[f"layers.{layer_index(cfg, j, r)}.{name}"] = \
                    _row(leaf, r)
    for name, leaf in _leaves(tree.get("encoder", {}), "", is_leaf):
        for i in range(cfg.encoder_layers):
            src[f"encoder.{i}.{name}"] = _row(leaf, i)
    extra = set(tree) - set(top) - {"blocks", "prefix", "encoder"}
    if extra or set(src) != set(names):
        raise ValueError(
            f"param tree and model differ: tree only "
            f"{sorted(set(src) - set(names)) + sorted(extra)}, model only "
            f"{sorted(set(names) - set(src))}")
    return src


def _copy(name: str, dst: torch.Tensor, leaf) -> None:
    t = to_torch(leaf)
    if t.shape != dst.shape or t.dtype != dst.dtype:
        raise ValueError(f"{name}: tree has {tuple(t.shape)} {t.dtype}, "
                         f"port {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(t)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device=None
                    ) -> Model:
    """Build the port's model for ``cfg`` on ``device`` from the
    reference's param tree.  Every leaf must find a parameter of the same
    shape and dtype, and every parameter a leaf."""
    model = Model(cfg, device=device, generator=None)
    params = dict(model.named_parameters())
    src = _by_port_name(cfg, tree, params,
                        lambda t: not isinstance(t, dict))
    with torch.no_grad():
        for name, p in params.items():
            _copy(name, p, src[name])
    return model


def opt_state_from_jax(cfg: ModelConfig, opt: Dict[str, Any], model: Model
                       ) -> Dict[str, Any]:
    """The port's AdamW state (``optim.adamw``) for ``model`` from the
    reference's ``init_opt_state`` / ``apply_updates`` state, bit for
    bit, on the model's device."""
    params = dict(model.named_parameters())
    src = _by_port_name(cfg, opt["mu"], params,
                        lambda t: isinstance(t, dict) and set(t) == {"m",
                                                                      "v"})
    int8 = isinstance(next(iter(src.values()))["m"], dict)
    state = init_opt_state(model, AdamWConfig(
        moments_dtype="int8" if int8 else "fp32"))
    with torch.no_grad():
        for name, mu in state["mu"].items():
            for mom in ("m", "v"):
                if int8:
                    for part in ("q", "scale"):
                        _copy(f"{name}.{mom}.{part}", mu[mom][part],
                              src[name][mom][part])
                else:
                    _copy(f"{name}.{mom}", mu[mom], src[name][mom])
        state["step"].copy_(to_torch(np.asarray(opt["step"])))
    return state
