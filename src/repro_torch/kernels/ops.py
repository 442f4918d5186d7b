"""Public entry points over the hand-written kernels.

The engine, the serving loop and users call these, under the names the JAX
package's ``ops`` module uses; each kernel's plain PyTorch version sits
beside it under ``<name>_ref`` (the JAX package's ``<name>_jnp``).  Each
entry point dispatches on the device of its input (a CUDA tensor launches
the kernel, a CPU tensor runs the plain version; ``backend="reference"``
forces the MESI kernels' plain versions).  :data:`LAUNCHES` counts every
kernel's launches and its plain version's calls; :func:`reset_launches`
zeroes them.
"""
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.cache_sim import (  # noqa: F401
    cache_sim, cache_sim_ref, mesi_cache_sim, mesi_dyn_segment,
)
from repro_torch.kernels.cache_sim import mesi_segment as mesi_run_segment  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_ref,
)
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_attention, paged_attention_ref,
)
from repro_torch.kernels.stream_triad import (  # noqa: F401
    stream_triad, stream_triad_ref,
)
