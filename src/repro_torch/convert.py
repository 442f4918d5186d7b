"""Carry configurations and cache state over from the JAX package.

The JAX package's objects arrive as plain data: dataclasses as the dicts
``dataclasses.asdict`` makes of them, arrays as NumPy arrays.  The
functions here build the port's objects from them, so both packages can
compute on the same configuration and the same state — a carry produced
by ``repro.core.engine.init_batch_carry`` / ``run_batch_segment`` can be
continued by :func:`repro_torch.core.engine.run_batch_segment`, and the
epoch carry of ``repro.core.tiering_dyn.init_dyn_carry`` by
:func:`repro_torch.core.tiering_dyn.run_dynamic_segment`.  This module
imports neither JAX nor `repro`; callers do the JAX side.

A placement policy or a workload is identified by its class name, since
``asdict`` drops it: ``policy("ZNuma", {"cxl_fraction": 0.5})``,
``workload("HotCold", {"seed": 5, ...})``.

Model parameters and decode caches arrive as the JAX trees turned into
NumPy leaves (``jax.tree_util.tree_map(np.asarray, tree)``); bf16 leaves
(NumPy's ``bfloat16`` extension type) are carried bit for bit.
:func:`model_params`, :func:`opt_state` and :func:`dense_cache` unstack
the period axis the JAX package stacks for ``lax.scan``; leaves of any
rank (the MoE experts' (E, d, f)) come through unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch import workloads
from repro_torch.core import numa, route, spec
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.sampling import SamplingSpec
from repro_torch.core.simulator import SimConfig
from repro_torch.core.switch import SwitchConfig
from repro_torch.core.tiering_dyn import DynamicTiering
from repro_torch.core.timing import (CXLTiming, DramTiming, QueueModel,
                                     SSDTiming, TimingConfig)
from repro_torch.optim.adamw import OptState

POLICIES = {cls.__name__: cls for cls in (numa.ZNuma, numa.FlatMode,
                                          numa.WeightedInterleave,
                                          numa.ExplicitPageMap)}


def cache_params(d: Mapping[str, Any]) -> CacheParams:
    return CacheParams(**d)


def cpu_model(d: Mapping[str, Any]) -> CPUModel:
    return CPUModel(**d)


def queue_model(d: Mapping[str, Any]) -> QueueModel:
    return QueueModel(**d)


def dram_timing(d: Mapping[str, Any]) -> DramTiming:
    return DramTiming(**d)


def cxl_timing(d: Mapping[str, Any]) -> CXLTiming:
    # the CXL version is an IntEnum on both sides: carry it by value
    return CXLTiming(**{**d, "version": spec.CXLVersion(int(d["version"]))})


def ssd_timing(d: Mapping[str, Any]) -> SSDTiming:
    return SSDTiming(**d)


def timing_config(d: Mapping[str, Any]) -> TimingConfig:
    return TimingConfig(dram=dram_timing(d["dram"]), cxl=cxl_timing(d["cxl"]),
                        ssd=ssd_timing(d["ssd"]))


def policy(kind: str, fields: Mapping[str, Any]) -> numa.Policy:
    """The placement policy of class `kind` (``type(p).__name__``)."""
    if kind not in POLICIES:
        raise ValueError(f"unknown policy {kind!r}; one of {sorted(POLICIES)}")
    if kind == "ExplicitPageMap":
        return numa.ExplicitPageMap(tuple(fields["page_tiers"]))
    return POLICIES[kind](**fields)


def sim_config(d: Mapping[str, Any]) -> SimConfig:
    return SimConfig(dram_gib=d["dram_gib"],
                     expander_gib=tuple(d["expander_gib"]),
                     n_cores=d["n_cores"], cache=cache_params(d["cache"]),
                     timing=timing_config(d["timing"]),
                     cpu=cpu_model(d["cpu"]))


def dynamic_tiering(d: Mapping[str, Any]) -> DynamicTiering:
    return DynamicTiering(**d)


def sampling_spec(d: Mapping[str, Any]) -> SamplingSpec:
    return SamplingSpec(**d)


def topology_spec(d: Mapping[str, Any]) -> route.TopologySpec:
    sw = d["switch"]
    return route.TopologySpec(
        name=d["name"], expander_gib=tuple(d["expander_gib"]),
        switch=None if sw is None else SwitchConfig(**sw),
        dram_gib=d["dram_gib"], ssd_gib=d["ssd_gib"])


def workload(kind: str, fields: Mapping[str, Any]) -> workloads.Workload:
    """The workload of class `kind` (``type(w).__name__``)."""
    by_class = {cls.__name__: cls for cls in workloads.REGISTRY.values()}
    if kind not in by_class:
        raise ValueError(f"unknown workload {kind!r}; one of "
                         f"{sorted(by_class)}")
    return by_class[kind](**fields)


def carry_from_numpy(*leaves, device=None) -> Tuple[torch.Tensor, ...]:
    """A carry of NumPy arrays as int32 tensors on `device`.

    Either the packed batch carry ``(l1p, l2p, stats, t)`` of
    ``init_batch_carry`` — (B, cores, s1, w1, 3), (B, s2, w2, 5),
    (B, nstats) and (B,) — or the 9-tuple epoch carry of
    ``init_dyn_carry``, which adds ``page_map`` and ``counts`` (B, P),
    ``mig_rd`` and ``mig_wr`` (B, T) and ``eidx`` (B,).
    """
    return tuple(torch.from_numpy(np.array(x, dtype=np.int32, copy=True))
                 .to(device) for x in leaves)


def carry_to_numpy(carry) -> Tuple[np.ndarray, ...]:
    """The carry as host int32 NumPy arrays (what JAX accepts back)."""
    return tuple(x.cpu().numpy().astype(np.int32) for x in carry)


def _tensor(a, device=None) -> torch.Tensor:
    """A NumPy array as a tensor of the same dtype, bf16 included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return (torch.from_numpy(np.array(a, copy=True).view(np.int16))
                .view(torch.bfloat16).to(device))
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device):
    if isinstance(node, Mapping):
        return {k: _tree(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device) for v in node]
    return _tensor(node, device)


def _unstack(node, i: int):
    """Period `i` of a tree whose leaves carry a leading period axis."""
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _periods(seg) -> List[Dict]:
    n = len(np.asarray(_first_leaf(seg)))
    return [_unstack(seg, i) for i in range(n)]


def _first_leaf(node):
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return node


def model_params(cfg, tree: Mapping, device=None) -> Dict:
    """The port's parameters from the JAX ``init_params`` tree.

    Every leaf keeps its name and dtype; each segment's stacked period
    axis becomes a list of per-period dicts
    (``params["segments"][seg][period]["b0"]...``).  `cfg` is accepted for
    the reference's signature and checks the depth.
    """
    out = {k: _tree(v, device) for k, v in tree.items() if k != "segments"}
    out["segments"] = [_tree(_periods(seg), device)
                       for seg in tree["segments"]]
    depth = sum(len(seg) * len(seg[0]) for seg in out["segments"])
    if depth != cfg.n_layers:
        raise ValueError(f"the tree holds {depth} blocks, {cfg.arch} has "
                         f"{cfg.n_layers} layers")
    return out


def opt_state(cfg, tree, device=None):
    """The port's :class:`repro_torch.optim.adamw.OptState` from the JAX
    package's ``OptState`` (step, m, v): the moments unstacked as
    :func:`model_params` unstacks the parameters."""
    step, m, v = tree
    return OptState(step=_tensor(step, device),
                    m=model_params(cfg, m, device),
                    v=model_params(cfg, v, device))


def dense_cache(tree, device=None) -> List:
    """The port's decode caches from the JAX cache list (one stacked tree
    per segment): ``caches[seg][period]["b0"]``, each entry's leaves as
    they come (``k``/``v``, MLA's ``ckv``/``krope``, the rwkv and rec
    states)."""
    return [_tree(_periods(seg), device) for seg in tree]
