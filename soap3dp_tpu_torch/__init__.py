"""soap3dp_tpu_torch — the PyTorch / CUDA port of soap3dp_tpu.

The JAX package ``soap3dp_tpu`` is the reference: this package keeps
its module layout and function names, so every function here has a
counterpart of the same name there. Device code is plain PyTorch on
tensors with an explicit ``device``; the fused banded DP
(``kernels/banded_dp.py``) is a hand-written CUDA kernel for Hopper
(``csrc/banded_dp.cu``) with its plain-torch version beside it.

Host code that imports no JAX is shared with the reference package
rather than copied: ``index/*``, ``io/*``, ``pipeline/options.py``,
``pipeline/overlap.py``, ``utils/{dna,shapes,rhash,timers}.py`` and
``cli/ini.py``. Nothing in this package imports ``jax``
(tests/test_torch_imports.py enforces it).
"""

__all__: list[str] = []
