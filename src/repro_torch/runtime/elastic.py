"""Elastic resizing: the device grid rebuilt from surviving hosts.

The port of ``repro.runtime.elastic``.  The policy: shrink the *data*
axis to the largest power of two that the surviving chip count supports
(the model axis is never resized: it would invalidate weight sharding),
then restore from the newest checkpoint.  The port has no mesh type:
:func:`remesh` returns the (data, model) grid of devices as nested lists.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def shrink_data_axis(n_live_chips: int, model_size: int) -> Tuple[int, int]:
    """-> (data_size, chips_used). Keeps TP intact, shrinks DP."""
    if n_live_chips < model_size:
        raise ValueError("fewer chips than one TP group — cannot continue")
    data = largest_pow2_leq(n_live_chips // model_size)
    return data, data * model_size


def remesh(devices: Sequence, data_size: int, model_size: int
           ) -> List[List[torch.device]]:
    """The first data_size x model_size `devices` as a (data, model) grid."""
    use = [torch.device(d) for d in devices[: data_size * model_size]]
    if len(use) != data_size * model_size:
        raise ValueError(f"{len(use)} devices for a {data_size} x "
                         f"{model_size} grid")
    return [use[i * model_size:(i + 1) * model_size]
            for i in range(data_size)]
