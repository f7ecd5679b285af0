"""PyTorch + CUDA port of the Quartet serving path.

Mirrors ``repro`` module for module (``repro/X.py`` → ``repro_torch/X.py``)
but imports only ``torch`` and ``numpy``: the JAX package is the reference
the port is tested against, never a dependency.  The three Pallas kernels
on the serving path (grouped-Hadamard QuEST quantize, MXFP4 GEMM, paged
attention) are hand-written CUDA C++ for Hopper under ``csrc/``, built with
``nvcc`` at first use (``kernels/_build.py``).
"""
