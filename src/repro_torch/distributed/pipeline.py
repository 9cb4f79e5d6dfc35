"""GPipe-style pipeline parallelism over the 'pod' axis (port of
``repro/distributed/pipeline.py``).

The layer stack is split into ``n_stages`` contiguous stages, one per
rank of the axis, and ``n_micro`` microbatches stream through them in the
classic fill-drain loop: at tick t, stage s works on microbatch t - s when
0 <= t - s < n_micro; activations hop stage s -> s + 1 around the ring
(``dist.batch_isend_irecv``, JAX's ``ppermute``).  Bubble fraction =
(S - 1) / (T + S - 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _stage_slice(tree, stage: int):
    """This stage's parameters: a DTensor sharded on its leading (stage)
    dim gives its local ``[1, ...]`` block, a full tensor its row."""
    if isinstance(tree, dict):
        return {k: _stage_slice(v, stage) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, stage) for v in tree)
    if isinstance(tree, DTensor):
        return tree.to_local()[0]
    return tree[stage]


def _ring_shift(y: torch.Tensor, group, stage: int, n: int) -> torch.Tensor:
    """Send ``y`` to stage + 1 and receive stage - 1's (mod n)."""
    if n == 1:      # a ring of one: the permutation is the identity
        return y
    ranks = dist.get_process_group_ranks(group)
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), ranks[(stage + 1) % n],
                      group),
           dist.P2POp(dist.irecv, buf, ranks[(stage - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def pipeline_forward(mesh, stage_fn, stacked_params, x_micro,
                     axis_name: str = "pod"):
    """Run microbatches through pipeline stages laid out on ``axis_name``.

    stage_fn(params_stage, x) -> x   per-stage transform
    stacked_params: tree with leading dim == n_stages (DTensors sharded
        on it over the axis, or full tensors)
    x_micro: [n_micro, micro_batch, ...] microbatched input (replicated)
    Returns [n_micro, micro_batch, ...] outputs, the same on every rank.
    """
    names = tuple(mesh.mesh_dim_names)
    n_stages = mesh.shape[names.index(axis_name)]
    group = mesh.get_group(axis_name)
    stage = mesh.get_local_rank(axis_name)
    n_micro = x_micro.shape[0]
    params_stage = _stage_slice(stacked_params, stage)
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                       # the microbatch this stage sees
        idx = min(max(mb, 0), n_micro - 1)
        x_in = x_micro[idx] if stage == 0 else buf
        active = 0 <= mb < n_micro
        y = stage_fn(params_stage, x_in)
        if not active:
            y = torch.zeros_like(y)
        buf = _ring_shift(y, group, stage, n_stages)
        if stage == n_stages - 1 and active:
            outs[idx] = y
    # The last stage's outputs to every rank (a masked sum).
    if stage != n_stages - 1:
        outs = torch.zeros_like(outs)
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
