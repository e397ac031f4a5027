"""Kernels of the port: the packed wire layout (``bitpack``), the plain
versions (``ref``), seven hand-written CUDA kernels for Hopper in three
modules (``fused_unify``: packed and bool fused unify and Eq. 2 alone;
``masked_agg``: packed and bool Eq. 3+4; ``sign_sim``: packed and dense
Eq. 5; sources in ``csrc/``, built by ``build``) and the dispatch layer
the engine uses (``ops``).  Importing a module here builds nothing:
kernels compile at first launch.
"""
