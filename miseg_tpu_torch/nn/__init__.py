"""PyTorch blocks, channel-last, named after the flax module tree."""
