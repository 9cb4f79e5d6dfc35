"""Logical-axis sharding rules -> DTensor placements over a DeviceMesh
(port of ``repro/distributed/sharding.py``).

The model code annotates parameters with *logical* axis names (one tuple
entry per array dim, ``models/*_pspec``); this module maps them onto a
mesh with the JAX package's rules:

  single-pod mesh: (data=16, model=16)
  multi-pod mesh:  (pod=2, data=16, model=16)   -- 'pod' extends data

  vocab -> model, embed -> data (FSDP), embed_sharded -> model, mlp ->
  model, q_heads / kv_heads -> model, experts -> model, ssm_inner ->
  model, layers -> None.

A resolved leaf is a :class:`NamedSharding`: the mesh and the physical
spec (per array dim: None, a mesh axis or a tuple of axes, JAX's
``PartitionSpec``), with its DTensor ``placements`` (per mesh dim:
``Shard(dim)`` or ``Replicate()``).  Resolution reads only the mesh's
axis names and sizes, so :class:`AbstractMesh` checks the production
shapes without 256 ranks; laying tensors out (:func:`distribute`) needs
a ``DeviceMesh`` over the running process group.  The port's parameter
trees keep a per-layer list where JAX stacks a leading ``"layers"``
axis, so a port leaf's spec is JAX's with that first entry dropped.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

PARAM_RULES = {
    "vocab": "model",
    "embed": "data",
    "embed_sharded": "model",
    "mlp": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "ssm_inner": "model",
    "layers": None,
    None: None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or ranks."""

    shape: tuple
    mesh_dim_names: tuple


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> dict:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` (JAX's PartitionSpec entries, one per array dim) on
    ``mesh`` (a DeviceMesh or an AbstractMesh)."""

    mesh: object
    spec: tuple

    def __post_init__(self):
        # JAX's PartitionSpec spells a one-axis tuple as the axis.
        object.__setattr__(self, "spec", tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in self.spec))

    @property
    def placements(self) -> tuple:
        """One placement per mesh dim: ``Shard(d)`` for the array dim
        ``d`` whose entry names it, else ``Replicate()``.  An array dim
        over several mesh axes (``('pod', 'data')``) is split major to
        minor in the mesh's own axis order, as DTensor does."""
        names = _names(self.mesh)
        out = [Replicate()] * len(names)
        for d, ax in enumerate(self.spec):
            axes = () if ax is None else ((ax,) if isinstance(ax, str)
                                          else tuple(ax))
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {ax!r} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a dict / list tree (tuples are leaves:
    they are the logical specs)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def resolve_param_specs(pspec_tree, mesh, rules=None):
    """Logical tuples -> a NamedSharding tree for ``mesh``.  A logical
    name whose rule names an axis the mesh lacks is replicated."""
    rules = dict(PARAM_RULES, **(rules or {}))
    axes = set(_names(mesh))

    def leaf_to_sharding(leaf):
        assert isinstance(leaf, tuple), f"bad pspec leaf: {leaf!r}"
        phys = []
        for name in leaf:
            ax = rules.get(name, None)
            phys.append(ax if ax in axes else None)
        return NamedSharding(mesh, tuple(phys))

    return _map(leaf_to_sharding, pspec_tree)


def batch_axes(mesh) -> tuple:
    """Physical axes of the global-batch dim on this mesh."""
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def _prod_axis(mesh, names) -> int:
    n = 1
    shape = _sizes(mesh)
    for name in names:
        n *= shape.get(name, 1)
    return n


def data_specs(mesh, batch_shape_tree):
    """NamedSharding per input: dim 0 (batch) over data(+pod) when it
    divides, else replicated; ``positions`` [3, B, S] shards dim 1."""
    baxes = batch_axes(mesh)

    def spec_for(name, ndim, batch_size):
        b_ax = baxes if batch_size % _prod_axis(mesh, baxes) == 0 else None
        if name == "positions" and ndim == 3:
            return NamedSharding(mesh, (None, b_ax, None))
        return NamedSharding(mesh, (b_ax,) + (None,) * (ndim - 1))

    return {k: spec_for(k, v.ndim, v.shape[1]
                        if k == "positions" and v.ndim == 3 else v.shape[0])
            for k, v in batch_shape_tree.items()}


def cache_specs(mesh, caches_shape_tree, cfg, batch: int,
                seq_shard: bool = True):
    """KV / SSM cache shardings for decode (``transformer.init_caches``'
    tree, leading layer axis): batch over data(+pod) when it divides;
    the KV sequence over 'model' (sequence-parallel decode) when the
    cached length divides; SSM states their heads, conv states their
    channels."""
    baxes = batch_axes(mesh)
    b_ax = baxes if batch % _prod_axis(mesh, baxes) == 0 else None
    model_n = _prod_axis(mesh, ("model",))

    def leaf_spec(name, leaf):
        nd = leaf.ndim
        if nd == 0:
            return NamedSharding(mesh, ())
        if "ssm" in name and nd >= 4:
            # [L, B, H, P, N]: heads over model when they divide.
            h_ax = "model" if (seq_shard and leaf.shape[2] % model_n == 0) \
                else None
            return NamedSharding(mesh, (None, b_ax, h_ax)
                                 + (None,) * (nd - 3))
        if ("cross_k" in name or "cross_v" in name or name.endswith("k")
                or name.endswith("v")) and nd == 5:
            # [L, B, S, KVH, HD]: the KV sequence over model.
            s_ax = "model" if (seq_shard and leaf.shape[2] % model_n == 0) \
                else None
            return NamedSharding(mesh, (None, b_ax, s_ax, None, None))
        if "scale" in name and nd == 4:
            # int8-KV scales [L, B, S, KVH] follow the cache's sequence.
            s_ax = "model" if (seq_shard and leaf.shape[2] % model_n == 0) \
                else None
            return NamedSharding(mesh, (None, b_ax, s_ax, None))
        if "conv" in name and nd == 4:
            # [L, B, K-1, C]: channels over model.
            c_ax = "model" if leaf.shape[3] % model_n == 0 else None
            return NamedSharding(mesh, (None, b_ax, None, c_ax))
        if nd == 1:   # per-layer 'len'
            return NamedSharding(mesh, (None,))
        return NamedSharding(mesh, (None, b_ax) + (None,) * (nd - 2))

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        return leaf_spec(prefix, node)

    return walk("", caches_shape_tree)


def constrain(x, dim_axes: dict, *, carry: bool = False):
    """Mesh-aware sharding constraint usable from model code.

    ``dim_axes`` maps dim -> mesh axis name(s) ('data' / 'model' /
    'batch', 'batch' being ('pod', 'data') when the mesh has a pod axis)
    or None to force that dim replicated.  Dims not listed keep their
    placement.  On a DTensor it is a ``redistribute`` to that layout; a
    dim that does not divide, or an axis the mesh lacks, is skipped.

    On any other tensor it is a no-op, as JAX's is outside a mesh: the
    port's mesh path (``distributed/spmd.py``) runs the model on each
    rank's local tensors, its rows of the batch already, and computes
    the tensors of JAX's other sites whole on every rank.  The one case
    is ``carry``, a tensor carried from one block to the next (JAX's
    residual-stream site under ``act_shard``): inside ``spmd.scope`` it
    is held as this rank's chunk of each dim mapped to 'model'
    (``spmd.model_shard``: a copy, no communication; skipped where the
    dim does not divide or the axis has one rank), and the next block
    all-gathers it at its entry (``spmd.model_whole``)."""
    if not isinstance(x, DTensor):
        if carry:
            from repro_torch.distributed import spmd  # spmd imports this
            for dim, ax in dim_axes.items():
                if ax == "model":
                    x = spmd.model_shard(x, dim)
        return x
    mesh = x.device_mesh
    names = _names(mesh)
    shape = _sizes(mesh)
    placements = list(x.placements)
    for dim, ax in dim_axes.items():
        dim = dim % x.ndim
        if ax is None:
            placements = [Replicate() if (p.is_shard() and p.dim == dim)
                          else p for p in placements]
            continue
        if ax == "batch":
            ax = batch_axes(mesh)
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if not all(a in names for a in axes):
            continue
        n = 1
        for a in axes:
            n *= shape[a]
        if x.shape[dim] % n != 0:
            continue
        placements = [Replicate() if (p.is_shard() and p.dim == dim)
                      else p for p in placements]
        for a in axes:
            placements[names.index(a)] = Shard(dim)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def logits_spec(mesh, batch: int) -> NamedSharding:
    baxes = batch_axes(mesh)
    b_ax = baxes if batch % _prod_axis(mesh, baxes) == 0 else None
    return NamedSharding(mesh, (b_ax, None, "model"))


def distribute(tree, shardings):
    """Lay every tensor of ``tree`` out by the matching NamedSharding of
    ``shardings`` (``jax.device_put`` with a sharding tree): a DTensor
    on its mesh.  Every rank holds the same full tensor (the same seed or
    the same checkpoint), so each takes its own shard without
    communication."""
    def put(x, sh):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x, sh.mesh, sh.placements,
                                 src_data_rank=None)
    return _map(put, tree, shardings)
