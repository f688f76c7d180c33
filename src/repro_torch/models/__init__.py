"""The LM substrate on PyTorch: config schema and registry (copies of the
reference's), layers, model assembly and the weight converter.  As the
reference's package, it re-exports the entry points; ``Model`` takes the
place of the reference's ``init_params``."""
from .config import ModelConfig
from .model import Model, decode_step, forward, loss_fn, param_specs
from .registry import get_config, list_archs

__all__ = ["ModelConfig", "Model", "forward", "loss_fn", "decode_step",
           "param_specs", "get_config", "list_archs"]
