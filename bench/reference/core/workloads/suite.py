"""The 20-workload registry (paper Table 1): 14 base models + 6
post-training-quantized INT4/INT8 LLM variants.

Selection criteria (paper §4.1): exercise all 23 operator types, stress
every execution path (MAC / DSP / Special-Function), span five orders of
magnitude in arithmetic intensity, and cover production INT4/INT8
quantization.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

from ..ir import Precision, WorkloadGraph
from .cnn import resnet50, snn_vgg9
from .misc import gnn_gat, kan
from .ssm import hyena_1_3b, mamba_370m, nemotron_h
from .transformer import lavish, llama7b, llava, mixtral, rt2, spec_decode, vit_b16

__all__ = ["SUITE_BUILDERS", "build", "suite", "workload_names", "GROUPS"]

SUITE_BUILDERS: Dict[str, Callable[[], WorkloadGraph]] = {
    # --- 14 base models (ten architectural families) ---
    "resnet50_int8": resnet50,
    "vit_b16_fp16": lambda: vit_b16(Precision.FP16),
    "llama7b_fp16": lambda: llama7b(Precision.FP16),
    "spec_decode": spec_decode,
    "mixtral_fp16": lambda: mixtral(Precision.FP16),
    "nemotron_h_fp16": lambda: nemotron_h(Precision.FP16),
    "mamba_370m": mamba_370m,
    "hyena_1_3b": hyena_1_3b,
    "kan": kan,
    "snn_vgg9": snn_vgg9,
    "lavish": lavish,
    "llava": llava,
    "rt2": rt2,
    "gnn_gat": gnn_gat,
    # --- 6 post-training-quantized variants ---
    "vit_b16_int8": lambda: vit_b16(Precision.INT8),
    "llama7b_int8": lambda: llama7b(Precision.INT8),
    "llama7b_int4": lambda: llama7b(Precision.INT4),
    "mixtral_int4": lambda: mixtral(Precision.INT4),
    "nemotron_h_int8": lambda: nemotron_h(Precision.INT8),
    "nemotron_h_int4": lambda: nemotron_h(Precision.INT4),
}

# Three-group taxonomy (paper §5.3) for the 15 MAC/DSP-dominant workloads,
# plus the five non-MAC workloads served by the Special-Function tile.
GROUPS = {
    "int_quantized": ["resnet50_int8", "vit_b16_int8", "llama7b_int8",
                      "llama7b_int4", "mixtral_int4", "nemotron_h_int8",
                      "nemotron_h_int4", "gnn_gat"],
    "fp16_transformer_ssm": ["vit_b16_fp16", "llama7b_fp16", "mixtral_fp16",
                             "nemotron_h_fp16", "mamba_370m", "llava"],
    "bandwidth_bound": ["spec_decode"],
    "non_mac": ["kan", "snn_vgg9", "hyena_1_3b", "lavish", "rt2"],
}


def workload_names() -> List[str]:
    return list(SUITE_BUILDERS)


@functools.lru_cache(maxsize=None)
def build(name: str) -> WorkloadGraph:
    try:
        g = SUITE_BUILDERS[name]()
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; have {workload_names()}")
    g.validate()
    return g


def suite() -> Dict[str, WorkloadGraph]:
    return {name: build(name) for name in SUITE_BUILDERS}
