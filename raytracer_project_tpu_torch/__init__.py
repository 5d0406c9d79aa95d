"""raytracer_project_tpu_torch — the PyTorch/CUDA port of the path tracer.

A second package beside the JAX reference (`raytracer_project_tpu/`),
with the same module tree (`core/`, `models/`, `ops/`). Plain tensor code
is PyTorch; the three product kernels of the fused pool step (closest hit,
hit-record decode, shade-advance) are hand-written CUDA C++ for Hopper
(`csrc/*.cu`), built with nvcc at first use and bound with ctypes
(`kernels.py`). Each kernel keeps a plain PyTorch version beside it, which
is what runs on CPU tensors.

This package never imports `jax` or the JAX package.
"""

__version__ = "0.1.0"
