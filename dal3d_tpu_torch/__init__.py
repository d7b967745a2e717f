"""PyTorch / CUDA port of ``dal3d_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dal3d_tpu`` stays the reference; this package mirrors its
module paths (``ops/banded.py`` <-> ``ops/banded.py``, ...) and its public
layouts (NHWC BEV maps, the brick layout ``[B, Mb, bw*C]``, sparse-conv
weights ``[K, Cin, Cout]`` in z-major tap order), so each module can be held
against its counterpart on the same inputs.

It imports torch and numpy only. Every Pallas kernel on the ported path is a
hand-written CUDA kernel under ``ops/csrc/``, built with ``nvcc`` on first use
(``ops/_build.py``); on CPU tensors each kernel wrapper runs its plain PyTorch
version instead.
"""
