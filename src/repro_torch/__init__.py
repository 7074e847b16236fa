"""PyTorch/CUDA port of the ``repro`` package.

Ported slice by slice on the paper's ``tinyllava`` model: the
continuous-batching split-serve engine (2-bit RD-FSQ, NF-4 and
entropy-adaptive wires; bf16 or int8 KV pools; dense or packed int4/int3
weights), static ``generate``, and the paper's training step, with
hand-written CUDA kernels for Hopper (``sm_90a``) in place of every
Pallas kernel of the reference (``kernels/csrc``).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
never ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version, which the tests compare with the JAX package.
"""
