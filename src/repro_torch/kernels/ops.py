"""Public entry points over the hand-written kernels.

The engine and the serving loop call these, under the names the JAX
package's ``ops`` module uses.  Each dispatches on the device of its
input (a CUDA tensor launches the kernel, a CPU tensor runs the plain
version; ``backend="reference"`` forces the MESI kernels' plain
versions).  :data:`LAUNCHES` counts every kernel's launches and its plain
version's calls; :func:`reset_launches` zeroes them.
"""
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.cache_sim import (  # noqa: F401
    mesi_cache_sim, mesi_dyn_segment,
)
from repro_torch.kernels.cache_sim import mesi_segment as mesi_run_segment  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
