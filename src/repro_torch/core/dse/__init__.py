"""Design-space exploration engine on torch (paper §3.5, §4.5).

The two-stage multi-seed pipeline over the 12-knob joint space, every
search frontend scoring candidates through one cache-aware engine:
genome ``encoding``, the ``EvalEngine`` (``engine``), its ``api``
(``EngineConfig`` and the ``Evaluator`` protocol that the engine, the
service's ``DSEClient`` and the ``DSECluster`` of
``repro_torch.serve`` satisfy) and result ``store``s (in-process LRU,
persistent sqlite, tiered), workload preparation and the scan evaluator (``batch_eval``), the roofline bound
(``prefilter``), the Eq. 8 ``objective``, the ``pareto`` front, the
stratified ``sweep``, the GA (``ga``: the host loop, and ``ga_device``:
the device loop and the fused refinement over the device-resident
``device_memo``), ``bayes`` (Bayesian optimization), the fused §4
``pipeline`` with its ``checkpoint``, and deterministic ``faults``.
"""
from .api import EngineConfig, Evaluator
from .encoding import Genome, decode, random_genomes, GENOME_LEN
from .batch_eval import batch_evaluate, prepare_workload, prepare_configs
from .engine import EvalEngine, EngineStats, genomes_to_configs, genome_areas
from .pareto import pareto_front
from .objective import iso_area_savings, fitness
from .pipeline import PipelineResult, run_pipeline

__all__ = [
    "EngineConfig", "Evaluator",
    "Genome", "decode", "random_genomes", "GENOME_LEN",
    "batch_evaluate", "prepare_workload", "prepare_configs",
    "EvalEngine", "EngineStats", "genomes_to_configs", "genome_areas",
    "pareto_front", "iso_area_savings", "fitness",
    "PipelineResult", "run_pipeline",
]
