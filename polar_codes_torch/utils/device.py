"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device of `device`, with a CUDA index filled in ("cuda" ->
    "cuda:0"). Raises RuntimeError for a CUDA device when there is none:
    an entry point never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested, but no CUDA device is "
                "available; pass device='cpu' to run the plain versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
