"""CXLRAMSim core on PyTorch: the paper's contribution, with the cache
simulation on a CUDA card (or the CPU, when asked).

Layers (bottom-up): spec -> packet -> registers -> hdm -> topology ->
timing -> switch -> route -> numa -> cache -> stream -> machine ->
sampling -> tiering_dyn -> engine -> simulator.  The engine calls the
kernels of :mod:`repro_torch.kernels`, which build on :mod:`.cache` and
:mod:`.tiering_dyn`; so the entry points below are resolved on
first use rather than imported here, which would close that cycle.
"""
import importlib

_EXPORTS = {
    **dict.fromkeys(("Mesh", "ResilientExecutor", "ShardedExecutor",
                     "auto_mesh", "stream_traces"), "distribute"),
    **dict.fromkeys(("SweepSpec", "run_sweep", "run_traces"), "engine"),
    "SamplingSpec": "sampling",
    **dict.fromkeys(("CheckpointPolicy", "Fault", "FaultPlan",
                     "ResilienceError", "RetryPolicy", "RunKilled",
                     "RunReport"), "resilience"),
    **dict.fromkeys(("RouteMap", "TopologySpec", "build_route",
                     "build_route_from_system", "direct", "switched"),
                    "route"),
    **dict.fromkeys(("CXLRAMSim", "SimConfig"), "simulator"),
}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
