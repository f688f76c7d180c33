"""20-workload suite (paper Table 1): 14 base models in ten
architectural families plus six post-training-quantized INT4/INT8
variants, as parametric DAG functions; ``extract.extract_model`` turns
the LM substrate's model configs into the same IR."""
from .suite import SUITE_BUILDERS, build, suite, workload_names

__all__ = ["SUITE_BUILDERS", "build", "suite", "workload_names"]
