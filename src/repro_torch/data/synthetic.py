"""Synthetic CIFAR-like images for the VGG-8 experiments (port of
``synthetic_cifar`` in ``repro/data/synthetic.py``).

Per-class frequency/orientation patterns plus noise; CIFAR itself is not
available offline, so Fig. 10 is reproduced mechanistically on this set.
The noise is drawn from an explicit ``torch.Generator``: the same
distribution as the JAX package, not the same images.
"""
from __future__ import annotations

import math

import torch


def synthetic_cifar(gen: torch.Generator, n: int, n_classes: int = 10,
                    size: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Images [n, size, size, 3] in [0, 1] (NHWC) and labels [n], on
    ``gen``'s device."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    ar = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    cls = torch.arange(n_classes, device=dev)
    thetas = math.pi * cls.to(torch.float32) / n_classes
    freqs = 2 * math.pi * (2 + cls % 5).to(torch.float32) / size
    f = freqs[labels][:, None, None]
    proj = (xx[None] * torch.cos(thetas[labels])[:, None, None]
            + yy[None] * torch.sin(thetas[labels])[:, None, None])
    img = torch.stack([torch.sin(f * proj + c * 0.7) for c in range(3)],
                      dim=-1) * 0.35 + 0.5
    noise = 0.15 * torch.randn(img.shape, generator=gen, device=dev)
    jitter = 0.1 * torch.randn((n, 1, 1, 3), generator=gen, device=dev)
    return torch.clamp(img + noise + jitter, 0, 1), labels
