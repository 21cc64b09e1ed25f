"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions, and the build that compiles them at first use."""
