"""miseg_tpu_torch — the PyTorch/CUDA port of `miseg_tpu` for NVIDIA Hopper.

A standalone package: it imports torch, numpy and the standard library,
never JAX, flax or `miseg_tpu`.  Tensors are channel-last
(`[B, *spatial, C]`) at every public function, as in the JAX package, and
module/parameter names follow the flax paths so weights bridge
mechanically (`weights.state_dict_from_jax`).

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; on the CPU every hand-written kernel is replaced by its
plain PyTorch version (the kernels themselves need the card).
"""
