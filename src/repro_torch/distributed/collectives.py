"""Explicit collectives for the patterns SPMD must get right (port of
``repro/distributed/collectives.py``).

``seq_parallel_decode_attention`` is the flash-decode combine: the KV
cache is split on its *sequence* axis across the ranks of ``axis_name``;
each rank computes its partial (max, sum, weighted V) and the partials
are merged with logsumexp algebra by two all-reduces (MAX on the max,
SUM on the rescaled sum and V), so the wire carries O(B * H * D) bytes
per layer, independent of the context length.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _partial_decode(q, k_shard, v_shard, valid_mask):
    """Per-shard partials.  q: [B,1,H,D]; k/v: [B,S_shard,KVH,D].
    Returns (m [B,KVH,G], l [B,KVH,G], o [B,KVH,G,D])."""
    b, _, h, d = q.shape
    kvh = k_shard.shape[2]
    g = h // kvh
    qh = q[:, 0].reshape(b, kvh, g, d).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qh,
                          k_shard.to(torch.float32)) / math.sqrt(d)
    scores = torch.where(valid_mask[:, None, None, :], scores, -1e30)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_shard.to(torch.float32))
    return m, l, o


def _reducer(group):
    """``reduce(op, x)``: ``x`` all-reduced in place over ``group`` by
    ``op`` ("max" or "sum"); nothing moves in a group of one."""
    n = dist.get_world_size(group)
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def reduce(op, x):
        if n > 1:
            dist.all_reduce(x, op=ops[op], group=group)
        return x
    return reduce


def _combine(m, l, o, group):
    """Merge the shard partials with logsumexp weights (tiny
    collectives)."""
    reduce = _reducer(group)
    m_max = reduce("max", m.clone())
    corr = torch.exp(m - m_max)
    l_sum = reduce("sum", l * corr)
    o_sum = reduce("sum", o * corr[..., None])
    return o_sum / torch.clamp_min(l_sum, 1e-30)[..., None]


def _local_seq(x, mesh, axis_name: str) -> torch.Tensor:
    """This rank's sequence shard of a [B, S, ...] cache: a DTensor's
    local tensor, or the rank's equal slice of a full tensor."""
    if isinstance(x, DTensor):
        return x.to_local()
    n = mesh.shape[tuple(mesh.mesh_dim_names).index(axis_name)]
    s_local = x.shape[1] // n
    i = mesh.get_local_rank(axis_name)
    return x[:, i * s_local:(i + 1) * s_local]


def seq_parallel_decode_attention(mesh, q, k_cache, v_cache, n_valid,
                                  axis_name: str = "model"):
    """q [B,1,H,D] replicated over ``axis_name``; k/v [B,S,KVH,D] split on
    S over it (DTensors with ``Shard(1)`` there, or full tensors of which
    each rank takes its slice).  ``n_valid``: the global count of valid
    cache entries.  Returns [B,1,H,D], the same on every rank."""
    b, _, h, d = q.shape
    n = mesh.shape[tuple(mesh.mesh_dim_names).index(axis_name)]
    if k_cache.shape[1] % n:
        raise ValueError(f"a cache of {k_cache.shape[1]} positions does not "
                         f"split over {n} ranks of {axis_name!r}")
    s_local = k_cache.shape[1] // n
    k = _local_seq(k_cache, mesh, axis_name)
    v = _local_seq(v_cache, mesh, axis_name)
    idx = mesh.get_local_rank(axis_name)
    local_pos = idx * s_local + torch.arange(s_local, device=q.device)
    valid = (local_pos[None, :] < torch.as_tensor(
        n_valid, device=q.device)).expand(b, s_local)
    m, l, o = _partial_decode(q, k, v, valid)
    out = _combine(m, l, o, mesh.get_group(axis_name))
    return out.reshape(b, 1, h, d).to(q.dtype)
