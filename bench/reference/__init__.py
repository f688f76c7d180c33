"""The benchmark's plain reference: the rows that the program's engine
returns, worked out again without the program.

``model.py`` is the per-operator cost model of one tile and
``simulate.py`` walks one chip over one workload, by the exact mapping
and by the scan's in-scan mapping, both written here as scalar Python
from the paper's equations.  ``core`` holds frozen copies of what defines
the inputs (architecture and genome encoding, workloads and IR, compiler
passes 1-2, calibration, area), taken when the benchmark was defined and
never edited to follow the program.  ``rows.score`` is the entry point;
its ``precision="float32"`` is the lower-precision control.  Nothing
here imports ``repro_torch``, ``repro``, ``jax`` or ``torch``.
"""
