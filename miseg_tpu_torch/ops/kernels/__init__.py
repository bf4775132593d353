"""Hand-written kernels for Hopper, each beside its plain PyTorch version.

  * `fused_norm`: K1 (channel statistics) and K2 (apply), Triton;
  * `window_attention`: K5, CUDA C++ (`csrc/window_attention.cu`).

Triton and nvcc are used only when a kernel first launches on a CUDA
tensor, so these modules import on a host without either.
"""
