"""PyTorch/CUDA port of the adaptive CEP runtime (``repro``).

The JAX package ``repro`` stays as the reference; this package mirrors its
module layout and is held against it count for count.  It imports torch
and numpy, never jax and never a module of ``repro``.  Entry points run on
the CUDA device unless the caller asks for the CPU (``device="cpu"``).
"""
