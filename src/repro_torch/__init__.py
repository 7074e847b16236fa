"""PyTorch/CUDA port of the split-serve path of the ``repro`` package.

Slice 1 of the port: the continuous-batching split-serve engine on the
paper's ``tinyllava`` model, with hand-written CUDA kernels for Hopper
(``sm_90a``) in place of the four Pallas kernels that path runs (flash
prefill, the RD-FSQ wire quantize/dequantize, paged decode).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
never ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version, which the tests compare with the JAX package.
"""
