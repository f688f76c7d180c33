"""Design-space exploration engine on torch: genome ``encoding``, the
``EvalEngine`` (``engine``), its ``api`` and ``store``, workload
preparation (``batch_eval``), the roofline bound (``prefilter``), and the
search frontends on top of the engine: the Eq. 8 ``objective``, the
``pareto`` front, the stratified ``sweep``, the host ``ga`` and ``bayes``
(Bayesian optimization).  Import submodules directly."""
