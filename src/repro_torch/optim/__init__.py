"""Optimizer substrate of the port (a port of ``repro/optim``): AdamW with
float32 or int8-quantized moments, gradient clipping, the warmup-cosine
schedule, and int8 gradient compression with error feedback."""
from .adamw import AdamWConfig, apply_updates, init_opt_state
from .compression import (compress_int8, decompress_int8, ef_compress_tree,
                          init_error_state)
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "init_opt_state", "apply_updates", "warmup_cosine",
           "compress_int8", "decompress_int8", "ef_compress_tree",
           "init_error_state"]
