"""AdamW: global-norm clipping, warmup + cosine schedule, decoupled decay.

The port of ``repro.optim.adamw``.  Parameters are bf16 (norm scales and
the MoE router f32), gradients come in each parameter's dtype, and the
first and second moments are f32.  The schedule and the bias
corrections are computed in f32 on the step tensor, as the reference
computes them.

:func:`update` loops over the leaves as the reference does, and writes
the new parameters and moments **into the tensors it is given** and
returns those same trees: at full width a functional update would hold
two copies of the moments (a JAX step with donated buffers updates in
place as well).  A caller that needs the old state copies it first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_dtype: Optional[str] = None    # e.g. 'bfloat16' compression point


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero moments (f32, on each parameter's device) and step 0."""
    first = tree_mod.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=tree_mod.tree_map(zeros, params),
                    v=tree_mod.tree_map(zeros, params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (f32, 0-d)."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [x.to(F32).square().sum() for x in tree_mod.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _decayed(path, p: torch.Tensor) -> bool:
    """Decoupled weight decay on matrices only, by the reference's rank.

    The reference stacks each segment's periods along a leading axis, so a
    leaf under ``segments`` has one more dimension there than here: the
    f32 norm scales are (P, d) there and are decayed, while
    ``final_norm``'s (d,) scale is not.  So the rank of a leaf under
    ``segments`` counts that axis."""
    stacked = bool(path) and path[0] == "segments"
    return p.ndim + (1 if stacked else 0) >= 2


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params
           ) -> Tuple[Any, OptState, Dict]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}), with `params`,
    ``state.m`` and ``state.v`` updated in place."""
    if cfg.grad_dtype:
        dt = getattr(torch, cfg.grad_dtype)
        grads = tree_mod.tree_map(lambda g: g.to(dt), grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(F32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(F32))

    flat_g = tree_mod.leaves(grads)
    flat_m = tree_mod.leaves(state.m)
    flat_v = tree_mod.leaves(state.v)
    for (path, p), g, m, v in zip(tree_mod.leaves_with_path(params),
                                  flat_g, flat_m, flat_v):
        # the reference's expressions, evaluated in the same order; the
        # in-place forms keep at most two leaf-sized f32 temporaries
        gf = g.to(F32, copy=True).mul_(scale)   # `g` stays unclipped
        m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        del gf
        delta = m / b1c
        delta /= (v / b2c).sqrt_().add_(cfg.eps)
        if _decayed(path, p):
            delta.add_(p.to(F32), alpha=cfg.weight_decay)
        p.copy_(p.to(F32).sub_(delta.mul_(lr)))
        del delta
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, m=state.m, v=state.v), metrics
