"""Device resolution shared by the port's entry points."""
from __future__ import annotations

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
