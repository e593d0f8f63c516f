"""PyTorch/CUDA port of the C-LMBF existence index and its filter server.

Laid out module for module like ``repro`` (the JAX reference package):
``core/`` (bloom, compression, lmbf, memory, fixup, existence), ``nn/``,
``data/``, ``checkpoint/``, ``runtime/``, ``kernels/`` and
``serve_filter/``. The port imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro`` — so it runs on a machine that has no
JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written Hopper kernels under ``kernels/``
launch only on CUDA tensors, and their plain PyTorch versions serve CPU
tensors.
"""
