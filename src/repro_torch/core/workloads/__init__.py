"""20-workload suite (paper Table 1): 14 base models in ten
architectural families plus six post-training-quantized INT4/INT8
variants, as parametric DAG builders.  (``extract.py``, which converts
the LM substrate's models into the IR, is not ported yet.)"""
from .suite import SUITE_BUILDERS, build, suite, workload_names

__all__ = ["SUITE_BUILDERS", "build", "suite", "workload_names"]
