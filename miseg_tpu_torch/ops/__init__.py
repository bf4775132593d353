"""Functional core: norms, window utilities, rel-pos bias, initializers,
and the hand-written kernels (`ops.kernels`)."""
