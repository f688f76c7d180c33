"""MOSAIC on PyTorch and CUDA (NVIDIA Hopper): the port of the ``repro``
JAX package's design-space-exploration evaluation path (``core``) and of
its LM serving path (``models``, ``serve``).

The layout mirrors ``repro`` module for module
(``repro/core/simulator/costs.py`` -> ``repro_torch/core/simulator/costs.py``),
and this package imports neither ``jax`` nor ``repro``: it keeps its own
copy of every host-side module it needs.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
