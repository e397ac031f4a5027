"""Kernels of the port: the packed wire layout (``bitpack``), the plain
versions (``ref``), ten hand-written CUDA kernels for Hopper in five
modules (``fused_unify``: packed and bool fused unify and Eq. 2 alone;
``masked_agg``: packed and bool Eq. 3+4 over all tasks, and one task;
``sign_sim``: packed and dense Eq. 5; ``modulated_matmul``: the serving
path's fused LoRA matmul; ``mlstm_chunk``: the xLSTM prefill's chunkwise
mLSTM; sources in ``csrc/``, built by ``build``) and the dispatch layer
the engine and the serving path use (``ops``).  Importing a module here
builds nothing: kernels compile at first launch.
"""
