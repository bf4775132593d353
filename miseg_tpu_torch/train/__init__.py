"""Training: the optimizer factory (`optim`) and one train step (`engine`)."""
