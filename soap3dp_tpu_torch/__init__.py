"""soap3dp_tpu_torch — the PyTorch / CUDA port of soap3dp_tpu.

The JAX package ``soap3dp_tpu`` is the reference: this package keeps
its module layout and function names, so every function here has a
counterpart of the same name there. Device code is plain PyTorch on
tensors with an explicit ``device``; the fused banded DP
(``kernels/banded_dp.py``) is a hand-written CUDA kernel for Hopper
(``csrc/banded_dp.cu``) with its plain-torch version beside it.

The host code (index builder, readers and writers, options, ini,
utilities, and the native helpers' C++ sources in ``csrc/host/``) is
this package's own copy of the reference's: nothing here imports
``soap3dp_tpu`` or ``jax`` (tests/test_torch_imports.py enforces it).
The on-disk index format is the reference's, so an index built by
either package loads in both.
"""

__all__: list[str] = []
