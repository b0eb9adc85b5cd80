"""Hand-written Hopper kernels, their plain PyTorch versions and the
model-layout entry points."""
