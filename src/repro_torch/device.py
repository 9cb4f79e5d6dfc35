"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import functools

import torch


def resolve(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a torch.device.  A CUDA device on a machine without
    CUDA raises: the port's entry points run on the card unless the caller
    asks for the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """Streaming multiprocessors of the CUDA device ``dev``."""
    dev = torch.device(dev)
    return _sm_count(torch.cuda.current_device() if dev.index is None
                     else dev.index)
