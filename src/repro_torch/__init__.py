"""CXLRAMSim on PyTorch and CUDA: a port of the JAX package `repro`.

The package mirrors `repro` module for module (``repro_torch.core.cache``
is the counterpart of ``repro.core.cache``, and so on), imports neither JAX
nor `repro`, and runs its cache simulation on the CUDA card unless the
caller passes ``device="cpu"``.  Its hot path, the two-level MESI state
machine, is a hand-written CUDA kernel
(``repro_torch/kernels/csrc/mesi.cu``) built with `nvcc` at first use.

    from repro_torch.core import CXLRAMSim, SimConfig
    sim = CXLRAMSim(SimConfig())          # device defaults to the CUDA card
    sim.online("znuma")
    rows = sim.stream_suite((2, 4, 6, 8))
"""
