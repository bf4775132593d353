"""Hand-written kernels for Hopper, each beside its plain PyTorch version.

  * `fused_norm`: K1 (channel statistics, and the fold of K4's partials),
    K2 (apply) and K3 (the two-branch tail), CUDA C++
    (`csrc/fused_norm.cu`, `csrc/norm_apply.cu`);
  * `fused_conv`: K4 (3x3x3 conv with norm-on-read and output
    statistics), CUDA C++ (`csrc/fused_conv.cu`);
  * `window_attention`: K5, CUDA C++ (`csrc/window_attention.cu`).

Each kernel entry is also a `torch.library` op (`miseg::*`) with a fake,
a "cpu" (plain) and a "cuda" (kernel) implementation, which the wrappers
call while tracing (`torch.export`).  nvcc runs only when a kernel first
launches on a CUDA tensor (`build.py`), so these modules import on a host
without it.
"""
