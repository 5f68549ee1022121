"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card: the port runs there unless the caller
    asks for another device (the CPU tests pass ``device="cpu"``).  Raises
    when CUDA is asked for, explicitly or by default, and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return dev
