"""Frozen copies of what defines the inputs: the chip architecture and its
genome encoding, the workload suite and its IR, compiler passes 1-2, the
calibration table and the area model.  Nothing here costs an operator or
places one: that is ``bench/reference/model.py`` and ``simulate.py``."""
