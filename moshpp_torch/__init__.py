"""MoSh++ stage-ii on PyTorch and CUDA: the port of `moshpp_tpu` to an
NVIDIA H100, with hand-written Hopper kernels in `csrc/`.

This package imports torch and never JAX.
"""
