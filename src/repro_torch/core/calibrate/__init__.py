"""Calibration layer (paper §3.4): the ASAP7-anchored energy / area /
timing table (``asap7``) and the NVDLA reference chips of the Table 2
cross-validation (``nvdla``).  Both are host data."""
from .asap7 import CalibrationTable, DEFAULT_CALIB
from .nvdla import NVDLA_SMALL, NVDLA_FULL, NVDLAPoint, nvdla_chip

__all__ = ["CalibrationTable", "DEFAULT_CALIB", "NVDLAPoint", "NVDLA_SMALL",
           "NVDLA_FULL", "nvdla_chip"]
