"""Host-side data: NIfTI IO, datalists and the invertible preprocessing
transforms (numpy, on the host, as in the JAX package)."""
