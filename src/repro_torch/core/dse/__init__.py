"""Design-space exploration engine on torch: genome ``encoding``, the
``EvalEngine`` (``engine``), its ``api`` and ``store``, workload
preparation (``batch_eval``) and the roofline bound (``prefilter``).
Import submodules directly."""
