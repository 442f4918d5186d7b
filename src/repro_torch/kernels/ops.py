"""Public entry points over the hand-written kernels.

The engine calls these, under the names the JAX package's ``ops`` module
uses.  Each dispatches on the device of its trace (a CUDA tensor launches
the kernel, a CPU tensor runs the plain version; ``backend="reference"``
forces the plain version) and counts its launches in :data:`LAUNCHES`.
"""
from repro_torch.kernels.cache_sim import (  # noqa: F401
    LAUNCHES, mesi_cache_sim, mesi_dyn_segment, reset_launches,
)
from repro_torch.kernels.cache_sim import mesi_segment as mesi_run_segment  # noqa: F401
