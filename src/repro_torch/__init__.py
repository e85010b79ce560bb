"""ODYS search engine, PyTorch/CUDA port of the JAX package ``repro``.

Mirrors ``repro``'s subpackages (``data``, ``core``, ``kernels``, ``obs``,
``serving``); each module names its counterpart.  Imports torch and
numpy only, never jax or ``repro``.
"""
