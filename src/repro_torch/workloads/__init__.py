"""Workload trace generators (see :mod:`.base` and :mod:`.microbench`).

==================  ======================================================
``stream``          the four STREAM kernels (the default axis entry)
``pointer_chase``   dependent loads over a permuted ring (MLP 1)
``gups``            seeded random read-modify-write (HPCC RandomAccess)
``hot_cold``        skewed-popularity random access over a scattered hot
                    page set — the dynamic-tiering driver
``kv_decode``       paged-attention decode gathers recorded from the
                    ``PagedKVCache`` + ``ContinuousBatcher`` serving loop,
                    with per-access HBM/CXL(/SSD) tier intent
==================  ======================================================

The JAX package's ``moe_stream`` generator and its ``pollution_probe``
are not ported yet: asking for them raises ``NotImplementedError`` naming
their ROADMAP item.
"""
from repro_torch.workloads.base import (  # noqa: F401
    Stream, Workload, WorkloadTrace, full_period_affine, lines_for_footprint,
    mix32, mix32_int, pages_for_lines,
)
from repro_torch.workloads.kv_decode import KVDecode  # noqa: F401
from repro_torch.workloads.microbench import Gups, HotCold, PointerChase  # noqa: F401

REGISTRY = {
    "stream": Stream,
    "pointer_chase": PointerChase,
    "gups": Gups,
    "hot_cold": HotCold,
    "kv_decode": KVDecode,
}

#: Generators of the JAX package still to port: name -> ROADMAP item.
UNPORTED = {"moe_stream": 5, "MoEStream": 5, "pollution_probe": 5}

WORKLOADS = tuple(REGISTRY)


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {name} workload is not ported to repro_torch yet (ROADMAP "
        f"queue 1, item {UNPORTED[name]})")


def get(name: str, **kwargs) -> Workload:
    """Instantiate a workload by registry name (``seed=...``, etc.)."""
    if name in UNPORTED:
        raise not_ported(name)
    if name not in REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {WORKLOADS}")
    return REGISTRY[name](**kwargs)


def __getattr__(name):
    if name in UNPORTED:
        raise not_ported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
