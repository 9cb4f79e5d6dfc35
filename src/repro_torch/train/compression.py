"""int8 gradient codec with error feedback (port of
``repro/train/compression.py``): the paper's static-scale int8
quantization applied to gradients.  ``compress`` quantizes a gradient
plus its carried residual on one f32 scale and returns the new residual;
``decompress`` undoes the scale.  ``compressed_psum`` is the int8
all-reduce over one mesh axis: the wire carries int8 codes (summed in
int32) and one f32 scale per tensor."""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def compressed_psum(g: torch.Tensor, err: torch.Tensor, axis_name: str,
                    *, mesh) -> tuple:
    """All-reduce an int8-quantized gradient across ``axis_name`` of
    ``mesh`` (the mean), JAX's steps in its order: the MAX of the local
    scales (a tiny f32 all-reduce), the codes on that shared scale
    (``torch.round`` is half-even like ``jnp.round``), the SUM of the
    codes in int32 (no overflow for <= 2**23 ranks), then ``q_sum *
    scale / n``.  Returns (the mean in ``g``'s dtype, the new error)."""
    group = mesh.get_group(axis_name)
    g_comp = g.to(torch.float32) + err
    scale = torch.clamp_min(g_comp.abs().amax(), 1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g_comp / scale), -127, 127).to(torch.int8)
    new_err = g_comp - q.to(torch.float32) * scale
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    g_mean = q_sum.to(torch.float32) * scale / n
    return g_mean.to(g.dtype), new_err


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
