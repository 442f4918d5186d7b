"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Kernels are built from ``csrc/`` with `nvcc` at first use
(:mod:`repro_torch.kernels.build`); importing this package builds nothing.
"""
