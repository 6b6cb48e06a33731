"""The adaptive CEP runtime's core, ported to PyTorch.

Control plane (host, numpy; copies of the JAX package's modules):
instrumented plan generators (``greedy``, ``zstream``), invariant machinery
(``invariants``), decision policies (``decision``), statistics estimation
(``stats``).  Data plane (torch): the order- and tree-plan engines
(``engine``) backed by the ``repro_torch.kernels`` CUDA join kernels,
batched over K stream partitions by ``fleet``.  ``ref_engine`` is the
brute-force ground-truth oracle and ``convert`` carries state over from
the JAX package.
"""
