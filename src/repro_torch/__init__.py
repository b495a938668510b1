"""PyTorch/CUDA port of the TurboMind-style mixed-precision serving system.

Mirrors the JAX package ``repro`` module for module (``repro_torch.core.
quantize`` ↔ ``repro.core.quantize`` and so on) for the slice that has been
ported: the paged W4A16KV8 serving engine of the dense family.  The two
TPU kernels on that path are hand-written CUDA C++ for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``kernels/_build.py``).  Every kernel wrapper runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.

The package imports ``torch`` and ``numpy`` only — never ``jax``,
``ml_dtypes`` or the JAX package.
"""
