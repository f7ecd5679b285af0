"""PyTorch + CUDA port of Quartet: FP4 training and FP4 serving.

Mirrors ``repro`` module for module (``repro/X.py`` → ``repro_torch/X.py``)
but imports only ``torch`` and ``numpy``: the JAX package is the reference
the port is tested against, never a dependency.  The Pallas kernels on the
serving and training paths (grouped-Hadamard QuEST quantize, randomized-
Hadamard stochastic-rounding quantize, MXFP4 GEMM, paged attention) are
hand-written CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``kernels/_build.py``).
"""
