"""Where the port's entry points run: the CUDA card unless the caller names
another device. Without a card only an explicit CPU request is honoured — an
entry point never carries on quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "grail_torch runs on CUDA by default and found no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


def check_on(t: torch.Tensor, device, what: str) -> None:
    """Raise unless tensor `t` lives on `device` (index-insensitive for a
    bare 'cuda' request)."""
    dev = torch.device(device)
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"{what} lives on {t.device}, but the call asked "
                         f"for {dev}")
