"""PyTorch and CUDA port of the sparse-kernel system in ``repro``.

The JAX package ``repro`` is the reference; this package imports nothing
of it, and nothing of JAX.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
