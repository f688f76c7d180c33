"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

* ``dse_eval`` -- the per-(candidate x op) myopic roofline lower bound
  (CUDA C++, ``csrc/dse_eval.cu``), replacing the Pallas
  ``repro/kernels/dse_eval.py::dse_eval_pallas``.

``ref`` holds the plain versions, ``ops`` the dispatch wrappers with
their launch counters.  Nothing is compiled at import: a kernel is built
(``nvcc``, into ``build/kernels/``) the first time a CUDA tensor reaches
its wrapper.
"""
