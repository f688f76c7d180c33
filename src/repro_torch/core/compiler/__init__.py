"""Cost-aware compiler (paper §3.2): four ordered passes.

(1) mixed-precision assignment (``precision``)  (2) operator fusion
(``fusion``)  (3) DAG-aware mapping with op-splitting, Eqs. 1-3
(``mapper``, host; ``batched_mapper``, a population on the card)
(4) schedule emission (``schedule``); ``pipeline`` drives them and lowers
a plan to the batched executor's op table.

The names below are loaded on first use, so importing the package loads
no submodule.
"""
import importlib

_EXPORTS = {
    "assign_precision": "precision", "fuse": "fusion",
    "map_graph": "mapper", "UnmappableError": "mapper",
    "emit_schedule": "schedule", "compile_workload": "pipeline",
    "batched_map": "batched_mapper", "map_and_simulate": "batched_mapper",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(name)
