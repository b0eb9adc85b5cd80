"""PyTorch/CUDA port of the BootSeer reproduction's model and serving path.

It sits beside the JAX package ``repro``, which stays the reference, keeps
its module layout and names, and imports nothing of it: what it needs from
framework-neutral modules there it keeps as its own copy. Hand-written
Hopper kernels live in ``csrc/`` and are built at first use.
"""
