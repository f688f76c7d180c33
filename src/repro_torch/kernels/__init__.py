"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

* ``dse_eval`` -- the per-(candidate x op) myopic roofline lower bound
  (CUDA C++, ``csrc/dse_eval.cu``), replacing the Pallas
  ``repro/kernels/dse_eval.py::dse_eval_pallas``.
* ``flash_attention`` -- blocked online-softmax attention forward (CUDA
  C++, ``csrc/flash_attention.cu``), replacing
  ``repro/kernels/flash_attention.py::flash_attention_pallas``, and its
  backward (``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``).
* ``ssm_scan`` -- the Mamba2 SSD chunked scan (CUDA C++,
  ``csrc/ssm_scan.cu``), replacing
  ``repro/kernels/ssm_scan.py::ssm_scan_pallas``, and its backward
  (``ssm_scan_bwd``, ``csrc/ssm_scan_bwd.cu``).
* ``horner`` -- Horner-rule polynomial evaluation (CUDA C++,
  ``csrc/horner.cu``), replacing
  ``repro/kernels/horner.py::horner_pallas``.

``ref`` holds the plain versions, ``ops`` the dispatch wrappers with
their launch counters, ``_build`` the shared ``nvcc`` build.  Nothing is
compiled at import: a kernel is built (``nvcc``, into ``build/kernels/``)
the first time a CUDA tensor reaches its wrapper.
"""
