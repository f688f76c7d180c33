"""Heterogeneity-aware analytical simulator (paper §3.3) on torch:
``costs`` (the shared float64 cost model), ``area`` (Eq. 7),
``orchestrator`` (schedule-mode and NoC constants) and ``batched`` (the
candidate-batched plan executor).  Import submodules directly."""
