"""PyTorch port of the FLECS-CGD reproduction (``repro``), for NVIDIA Hopper.

The layout mirrors ``src/repro``: ``core/``, ``data/`` and ``kernels/`` hold
the counterparts of the JAX modules of the same names.  The package imports
``torch`` and ``numpy`` only; the JAX package is the reference the tests
compare against.  See ``README.md`` beside this file.
"""
