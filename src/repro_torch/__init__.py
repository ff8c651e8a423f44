"""PyTorch and CUDA port of the Chameleon reproduction.

Mirrors the reference JAX package ``repro`` file for file; imports
``torch`` and never ``jax`` or ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
