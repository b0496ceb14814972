"""Hand-written CUDA kernels for the fabric, KVS and LM decode hot spots
(sm_90a).

Each kernel module holds the kernel's launch function, its plain PyTorch
version and a note on what it replaces and what bounds it; ``csrc/``
holds the CUDA sources and ``ops.py`` the dispatching wrappers with
their launch counts.
"""
