"""Assigned input-shape sets and their (shape, dtype) stand-ins (a port of
``repro/launch/shapes.py``).

Four shapes per LM architecture (seq_len x global_batch):
  train_4k     4,096 x 256   -> train_step
  prefill_32k  32,768 x 32   -> serve prefill (last-token logits + caches)
  decode_32k   32,768 x 128  -> serve_step: one new token, 32k KV cache
  long_500k    524,288 x 1   -> serve_step vs a 500k cache; ONLY for
                               sub-quadratic archs (SSM/hybrid) -- full-
                               attention archs skip it

``input_specs`` returns (``TensorStruct`` tree, ``PartitionSpec`` tree):
shapes and dtypes that allocate nothing, and their shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..distributed.sharding import PartitionSpec as P
from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCase", "TensorStruct", "input_specs",
           "cache_structs", "cache_specs_physical", "runnable",
           "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


class TensorStruct(NamedTuple):
    """A tensor's shape and dtype, with no storage behind it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def runnable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    if not runnable(cfg, shape):
        return ("pure full-attention architecture: 500k-token decode needs "
                "sub-quadratic sequence mixing")
    return None


def _ctx_specs(cfg: ModelConfig, B: int, batch_axes) -> Tuple[dict, dict]:
    """Frontend stubs: precomputed frame/patch embeddings."""
    structs, specs = {}, {}
    if cfg.encoder_layers:
        structs["frames"] = TensorStruct(
            (B, cfg.num_frontend_tokens, cfg.d_model), torch.float32)
        specs["frames"] = P(batch_axes, None, None)
    elif cfg.frontend == "vision":
        structs["vision_embeds"] = TensorStruct(
            (B, cfg.num_frontend_tokens, cfg.d_model), torch.float32)
        specs["vision_embeds"] = P(batch_axes, None, None)
    return structs, specs


def input_specs(cfg: ModelConfig, shape: str, *, multi_pod: bool = False):
    """(structs, pspecs) for the given shape case."""
    case = SHAPES[shape]
    b_axes = ("pod", "data") if multi_pod else ("data",)
    n_dp = 32 if multi_pod else 16
    B = case.global_batch
    batch_axes = b_axes if B % n_dp == 0 else None  # tiny-batch decode
    i32 = torch.int32
    if case.mode == "train":
        structs = {"tokens": TensorStruct((B, case.seq_len), i32),
                   "labels": TensorStruct((B, case.seq_len), i32)}
        specs = {"tokens": P(batch_axes, None), "labels": P(batch_axes, None)}
    elif case.mode == "prefill":
        structs = {"tokens": TensorStruct((B, case.seq_len), i32)}
        specs = {"tokens": P(batch_axes, None)}
    else:  # decode
        structs = {"tokens": TensorStruct((B, 1), i32),
                   "pos": TensorStruct((B,), i32)}
        specs = {"tokens": P(batch_axes, None), "pos": P(batch_axes)}
    cs, cp = _ctx_specs(cfg, B, batch_axes)
    structs.update(cs)
    specs.update(cp)
    return structs, specs


def cache_structs(cfg: ModelConfig, B: int, T: int
                  ) -> List[Optional[Dict[str, TensorStruct]]]:
    """The decode caches' shapes and dtypes in the port's layout
    (``models.model.init_cache``): one dict per layer, None for a
    cross-attention layer.  Built on the meta device: nothing is
    allocated."""
    from ..models.model import _init_layer_cache, _layer_kinds
    out = []
    for mk, _ in _layer_kinds(cfg):
        c = _init_layer_cache(cfg, mk, B, T, torch.device("meta"))
        out.append(None if c is None else
                   {k: TensorStruct(tuple(v.shape), v.dtype)
                    for k, v in c.items()})
    return out


def cache_specs_physical(cfg: ModelConfig, B: int, model_axis: int = 16,
                         multi_pod: bool = False):
    """Decode-cache PartitionSpecs on the physical mesh, one per layer in
    the port's layout (the reference's, without its stacked leading axis).

    KV shards over heads when kv_heads divides the model axis; otherwise
    over the sequence axis (SP) -- mandatory for MQA (granite kv=1) and
    the 500k-token caches.  batch==1 (long_500k) leaves batch unsharded
    and spreads the sequence across every DP device too."""
    from ..models.model import _layer_kinds
    b_axes = ("pod", "data") if multi_pod else ("data",)
    n_dp = 32 if multi_pod else 16
    batch = b_axes if B % n_dp == 0 else None
    seq_axes = "model" if batch is not None else (b_axes + ("model",))

    def one(mk: str):
        if mk == "mamba":
            return {"conv": P(batch, None, "model"),
                    "ssm": P(batch, "model", None, None)}
        if mk == "cross_attn":
            return None
        if cfg.mla:
            return {"ckv": P(batch, seq_axes, None),
                    "kr": P(batch, seq_axes, None),
                    "len": P(batch)}
        if cfg.n_kv_heads % model_axis == 0:
            kv = P(batch, None, "model", None)
        else:
            kv = P(batch, seq_axes, None, None)
        return {"k": kv, "v": kv, "len": P(batch)}

    return [one(mk) for mk, _ in _layer_kinds(cfg)]
