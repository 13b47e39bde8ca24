"""Kernels written by hand for Hopper, each beside its plain PyTorch
version (see ``csrc/`` for the sources and ``_build`` for the build)."""
