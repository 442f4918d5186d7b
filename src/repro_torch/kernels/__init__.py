"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Kernels are built from ``csrc/`` with `nvcc` at first use
(:mod:`repro_torch.kernels.build`); importing this package builds nothing.
Use :mod:`repro_torch.kernels.ops` (each entry point follows its input's
device); the plain versions under the JAX package's oracle names and call
forms live in :mod:`repro_torch.kernels.ref`.  Both are resolved on first
use: the kernel modules build on :mod:`repro_torch.core`, which imports
this package.
"""
import importlib

_SUBMODULES = ("ops", "ref")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
