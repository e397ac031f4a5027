"""Kernels of the port: the packed wire layout (``bitpack``), the plain
versions (``ref``), three hand-written CUDA kernels for Hopper
(``fused_unify``, ``masked_agg``, ``sign_sim``; sources in ``csrc/``,
built by ``build``) and the dispatch layer the engine uses (``ops``).
Importing a module here builds nothing: kernels compile at first launch.
"""
