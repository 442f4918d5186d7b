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
``moe_stream``      top-k expert-weight streaming from a real MoE config
==================  ======================================================

:func:`~repro_torch.workloads.pollution.pollution_probe` measures the LLC
pollution a CXL burst inflicts on a DRAM-resident tenant.
"""
from repro_torch.workloads.base import (  # noqa: F401
    Stream, Workload, WorkloadTrace, full_period_affine, lines_for_footprint,
    mix32, mix32_int, pages_for_lines,
)
from repro_torch.workloads.kv_decode import KVDecode  # noqa: F401
from repro_torch.workloads.microbench import Gups, HotCold, PointerChase  # noqa: F401
from repro_torch.workloads.moe_stream import MoEStream  # noqa: F401
from repro_torch.workloads.pollution import pollution_probe  # noqa: F401

REGISTRY = {
    "stream": Stream,
    "pointer_chase": PointerChase,
    "gups": Gups,
    "hot_cold": HotCold,
    "kv_decode": KVDecode,
    "moe_stream": MoEStream,
}

#: Generators of the JAX package still to port: none.
UNPORTED: dict = {}

WORKLOADS = tuple(REGISTRY)


def get(name: str, **kwargs) -> Workload:
    """Instantiate a workload by registry name (``seed=...``, etc.)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {WORKLOADS}")
    return REGISTRY[name](**kwargs)
