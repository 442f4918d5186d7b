"""CXLRAMSim on PyTorch and CUDA: a port of the JAX package `repro`.

The package mirrors `repro` module for module (``repro_torch.core.cache``
is the counterpart of ``repro.core.cache``, and so on), imports neither JAX
nor `repro`, and runs on the CUDA card unless the caller passes
``device="cpu"``.  Its hot paths are hand-written CUDA kernels built with
`nvcc` at first use: the two-level MESI state machine in
``repro_torch/kernels/csrc/mesi.cu`` for static sweeps and ``mesi_dyn.cu``
for the epoch-structured path (dynamic tiering, sampled simulation, the
CXL-SSD tier), and decode attention over the paged KV cache in
``paged_attention.cu`` for the serving path (``repro_torch.launch.serve``).

    from repro_torch.core import CXLRAMSim, SimConfig
    sim = CXLRAMSim(SimConfig())          # device defaults to the CUDA card
    sim.online("znuma")
    rows = sim.stream_suite((2, 4, 6, 8))
"""
