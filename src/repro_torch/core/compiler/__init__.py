"""Cost-aware compiler (paper §3.2): pass 1 (``precision``), pass 2
(``fusion``) and the candidate-batched exact Eq. 1-3 mapper
(``batched_mapper``).  Import submodules directly."""
