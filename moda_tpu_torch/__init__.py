"""moda_tpu_torch: the PyTorch/CUDA port of moda_tpu.

Mirrors moda_tpu's layout and names; imports torch and numpy, never JAX
and nothing of the moda_tpu package. The hand-written CUDA kernels of the
fused NeRF-MLP live in csrc/ and are built on first use.
"""
