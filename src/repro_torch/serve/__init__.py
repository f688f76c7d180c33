"""Serving substrate of the port: prefill/decode steps (``step``), the
continuous-batching engine (``engine``), the DSE evaluation service
(``dse_service``: a coalescing async front over ``core.dse.engine``) and
its worker cluster (``cluster``).

The names below are loaded on first use, so importing the package loads
no submodule (and ``python -m repro_torch.serve.dse_service`` runs its
module once).
"""
import importlib

_EXPORTS = {
    "make_prefill_step": "step", "make_decode_step": "step",
    "DSEService": "dse_service", "DSEClient": "dse_service",
    "ServiceStats": "dse_service",
    "DSECluster": "cluster", "ClusterStats": "cluster",
    "ClusterError": "cluster",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(name)
