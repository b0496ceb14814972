"""Dagger's RPC NIC fabric in PyTorch, with hand-written CUDA kernels.

The package mirrors ``repro``'s layout (``config``, ``core``,
``kernels``, ``runtime``, ``data``) and imports neither JAX nor
``repro``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on a CUDA
tensor every kernel wrapper launches its kernel or raises, and only CPU
tensors take a kernel's plain PyTorch version.
"""
