"""MOSAIC core on PyTorch: inputs (``ir``, ``arch``), compiler passes
(``compiler``), the candidate-batched simulator (``simulator``),
calibration (``calibrate``) and the DSE engine (``dse``).

Submodules are imported explicitly by their users; importing this
package loads nothing heavy.
"""
