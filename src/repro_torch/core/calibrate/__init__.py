"""Calibration layer (paper §3.4): the ASAP7-anchored energy / area /
timing table.  The NVDLA reference chips (``nvdla.py`` in ``repro``) are
not ported yet."""
from .asap7 import CalibrationTable, DEFAULT_CALIB

__all__ = ["CalibrationTable", "DEFAULT_CALIB"]
