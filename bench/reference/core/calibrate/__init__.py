"""Frozen copy of the calibration table (``asap7``)."""
