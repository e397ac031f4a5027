"""PyTorch/CUDA port of the MaTU reproduction (``repro``).

Same subpackage layout as the JAX package, so every module has an
obvious twin: ``kernels`` (bit-packed wire layout, plain versions, the
hand-written CUDA kernels and their dispatch), ``core`` (unify, client
wire types, round engine, server), ``common`` (device choice, task-vector
layout manifest), ``data``, ``optim``, ``fed`` (local training,
strategies, simulator, the zoo's backbones), ``train`` (the LoRA train
step), ``ckpt`` (checkpoints), and the model and serving stack:
``configs`` (the zoo and ViT-B/32), ``nn`` (LoRA-aware Dense, RoPE,
attention, MLPs, MoE, MLA, the SSM blocks), ``models`` (the decoder LM,
the encoder-decoder, the ViT and ``build_model``) and ``serve``
(modulator store, task router, multi-tenant decoder).

The port imports torch, numpy and the standard library only.  Every
entry point takes ``device=`` and defaults to ``"cuda"``; without a card
that default raises instead of running on the CPU.  Tensors on the CPU
take each kernel's plain PyTorch version, CUDA tensors take the kernel.
"""
