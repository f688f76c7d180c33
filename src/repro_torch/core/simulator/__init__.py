"""Heterogeneity-aware analytical simulator (paper §3.3) on torch.

``costs``        -- the shared float64 cost model (Eqs. 2/4-6) and the
                    FIFO activation-cache reference (``ActivationCache``);
``modules``      -- scalar/TileTemplate-typed wrappers over ``costs``;
``tile``         -- ``TileSim``: one operator through one tile's MAC /
                    DSP / Special-Function path;
``area``         -- the area model (Eq. 7);
``orchestrator`` -- ``ChipSim``, the reference oracle: the per-operator
                    host walk of a compiled plan (per-op trace, per-tile
                    breakdowns, chrome trace);
``outputs``      -- the result records and ``SimResult.golden_dict``;
``batched``      -- the candidate-batched plan executor on (B, MAX_TILES)
                    tensors, fed by the batched mappers or from plan
                    tables (``batch_simulate``, ``simulate_plans``).

The oracle is host code (numpy); what runs on the card is ``batched``.
The names below are loaded on first use, so importing the package loads
no submodule.
"""
import importlib

_EXPORTS = {
    "EnergyBreakdown": "outputs", "OpResult": "outputs",
    "TileBreakdown": "outputs", "SimResult": "outputs",
    "tile_area": "area", "chip_area": "area",
    "ActivationCache": "costs", "CostModel": "costs", "cost_model": "costs",
    "TileSim": "tile", "ChipSim": "orchestrator", "simulate": "orchestrator",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(name)
