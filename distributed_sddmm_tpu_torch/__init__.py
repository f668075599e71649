"""PyTorch / CUDA port of ``distributed_sddmm_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package so each counterpart is easy to find.
The port imports ``torch``, numpy and scipy only; the local tile kernels
are hand-written CUDA C++ (``ops/csrc/tile_kernels.cu``), built with
``nvcc`` at first use. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.
"""
