"""Where the port's entry points run: the CUDA card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present; the caller must pass ``device="cpu"`` to run on
    the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "simulator on the CPU")
    return dev
