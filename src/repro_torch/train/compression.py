"""int8 gradient codec with error feedback (port of
``repro/train/compression.py``): the paper's static-scale int8
quantization applied to gradients.  ``compress`` quantizes a gradient
plus its carried residual on one f32 scale and returns the new residual;
``decompress`` undoes the scale.  The all-reduce that uses them
(``compressed_psum``) belongs to the multi-device slice."""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_map


def compress(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """Returns (q int8, scale, new_err); ``err`` is carried f32 state."""
    g_comp = g.to(torch.float32) + err
    scale = torch.clamp_min(g_comp.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g_comp / scale), -127, 127).to(torch.int8)
    new_err = g_comp - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g, err, axis_name: str):
    """The int8 all-reduce across devices."""
    raise NotImplementedError(
        "compressed_psum is an all-reduce across devices, which is not "
        "ported yet (ROADMAP queue 1, multi-device)")


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
