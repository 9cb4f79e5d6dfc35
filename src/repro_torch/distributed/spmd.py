"""The model on a DeviceMesh: each rank runs the port's model code on
local tensors, with the collectives at fixed points (the counterpart of
what XLA's SPMD partitioner makes of the JAX package's pjit).

* **Parameters at rest** are DTensors laid out by
  ``sharding.resolve_param_specs`` (FSDP over data, tensor parallel over
  model).  :func:`localize` gathers them for compute: every leaf is
  replicated except, with ``keep_model``, a column-parallel linear (its
  output dim on 'model': q/k/v, gate/up, in_proj, the head) and the MoE
  expert banks (experts on 'model'), which keep this rank's model shard.
  A row-parallel linear (o, down, out_proj: input dim on 'model') is
  gathered to its full K, as XLA does around an opaque custom call.
* **Activations** hold this rank's rows of the global batch (data and pod
  axes) and are replicated over 'model', but for the residual stream
  where JAX holds it d-sharded: the token lookup runs in the table's
  model shard (:func:`gather_table`, JAX's ``embed_sharded`` layout) and
  gives this rank's d-chunk of the rows, and under ``act_shard`` a dense
  block's output is stored as its d-chunk (``sharding.constrain(...,
  carry=True)``, :func:`model_shard`); the next block, or the final
  norm, all-gathers the chunks at its entry (:func:`model_whole`).  A
  column-parallel linear (:class:`ColumnShard`) computes its local
  columns -- K1's epilogue is per column, so they are the full
  product's -- and all-gathers them over 'model'; the expert banks
  (:class:`ExpertShard`) run this rank's experts and all-gather their
  outputs.
* Reductions over the global batch (the MoE balance loss's means, the
  loss's token count) are all-reduced over the batch axes, the
  gradients reduce-scattered (below); :func:`batch_mean` is the identity
  outside :func:`scope`.

* **Memory**: the parameters stay at rest; the model code gathers
  them where it uses them, one block at a time (:func:`gather_block`,
  called inside the stack loops: the final norms and the head at their
  one use; the embedding keeps its model shard, :func:`gather_table`),
  by :func:`localize`'s rules, and drops the
  gathered tensors before the next block's gather.  A rank holds its
  shards, one gathered block and its activations: JAX's layout, where
  XLA gathers each layer's parameters inside the layer.
* **Training** (``scope(mesh, keep_model=False)``) gathers each leaf
  whole through :class:`Resting` leaves, a differentiable gather whose
  backward sums the gradient over the batch axes with a reduce-scatter
  on the leaf's data-sharded dim and keeps this rank's slice over
  'model' without communication (activations and their gradients are
  whole and the same on every rank there; the table's lookup gradient
  is its model shard's already): the train step receives gradient
  shards, never the full gradients.  Put
  inside a remat region, the checkpoint keeps the resting shards and the
  block input, and the recompute gathers again.
* **Decode caches** may hold this rank's shards as
  ``sharding.cache_specs`` lays them out (:func:`split_caches`): the KV
  sequence split over 'model' (:class:`SeqShard`: the owner of a
  position writes it, attention merges the shards' partials with the
  flash-decode combine of ``collectives``), SSM states their heads
  (:class:`StateShard`: a layer gathers its state, steps it and keeps
  its shard of the new one).

Outside :func:`scope` none of this runs: the model code is the
single-device code.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import sharding

_SCOPE: contextvars.ContextVar = contextvars.ContextVar("mesh_scope",
                                                        default=None)
# reduce_scatter_single is the newer name of reduce_scatter_tensor.
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


@contextlib.contextmanager
def scope(mesh, *, keep_model: bool = True):
    """Run the model code inside on ``mesh`` (its batch reductions
    all-reduce over the batch axes); :func:`gather_block` keeps the
    column-parallel linears' and expert banks' model shards when
    ``keep_model`` (serving) and gathers every leaf whole otherwise
    (training).  The scope keeps each subtree's gather plan
    (:func:`gather_block`) for its whole life: a serving call's steps
    reuse them."""
    token = _SCOPE.set(_Scope(mesh, keep_model))
    try:
        yield mesh
    finally:
        _SCOPE.reset(token)


class _Scope:
    __slots__ = ("mesh", "keep_model", "plans")

    def __init__(self, mesh, keep_model: bool):
        self.mesh, self.keep_model = mesh, keep_model
        # id(subtree) -> (subtree, run, its output where nothing moves)
        self.plans: dict = {}


def current_mesh():
    s = _SCOPE.get()
    return None if s is None else s.mesh


def bind_scope(fn):
    """``fn`` run inside the scope that is active now, wherever it is
    called from: a remat region's recompute runs in the backward pass,
    on CUDA in the autograd engine's device thread, which does not see
    the caller's context."""
    s = _SCOPE.get()
    if s is None:
        return fn

    def bound(*args, **kwargs):
        token = _SCOPE.set(s)
        try:
            return fn(*args, **kwargs)
        finally:
            _SCOPE.reset(token)
    return bound


class ColumnShard(dict):
    """A linear's params holding this rank's output columns over the
    'model' axis of ``mesh``."""

    mesh = None


class ExpertShard(dict):
    """An MoE bank dict holding this rank's experts, from ``lo`` on, over
    the 'model' axis of ``mesh``."""

    mesh = None
    lo = 0


def _model_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index("model")] if "model" in names else 1


def _want(x: DTensor, keep_model: bool) -> list:
    """The placements of ``x`` gathered: replicated on every mesh dim
    but, with ``keep_model``, 'model'.  A mesh dim of size one holds the
    whole tensor already: nothing moves over it."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    return [p if (keep_model and n == "model") or mesh.size(i) == 1
            else Replicate()
            for i, (n, p) in enumerate(zip(names, x.placements))]


def _gathered(x: DTensor, keep_model: bool) -> torch.Tensor:
    """``x`` in its :func:`_want` placements, as this rank's local
    tensor."""
    want = _want(x, keep_model)
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local()


def _model_shard_dim(x) -> int | None:
    """The array dim ``x`` shards over 'model', or None."""
    if not isinstance(x, DTensor):
        return None
    names = tuple(x.device_mesh.mesh_dim_names)
    if "model" not in names:
        return None
    p = x.placements[names.index("model")]
    return p.dim if p.is_shard() else None


def _split(x: DTensor) -> bool:
    """Whether the 'model' axis of ``x``'s mesh has more than one rank
    (on one, a column-parallel linear or an expert bank holds all of
    itself: the single-device code runs it)."""
    return _model_size(x.device_mesh) > 1


def _divides(x: DTensor, dim: int) -> bool:
    return x.shape[dim] % _model_size(x.device_mesh) == 0


_BANKS = ("gate", "up", "down")


class Resting:
    """A parameter leaf at rest for training: this rank's shard
    ``local`` (a plain tensor, the leaf autograd differentiates) and the
    layout of the DTensor it was taken from.  :func:`gather_block`
    gathers it through :class:`_GatherRest`."""

    __slots__ = ("local", "mesh", "placements", "shape", "stride")

    def __init__(self, local: torch.Tensor, like: DTensor):
        self.local = local
        self.mesh = like.device_mesh
        self.placements = tuple(like.placements)
        self.shape = like.shape
        self.stride = like.stride()


def _chunk(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Rank ``i``'s piece of ``x`` split ``n`` ways along ``dim`` as a
    DTensor ``Shard`` splits it (``torch.chunk``; trailing ranks of an
    uneven split may hold nothing)."""
    parts = torch.chunk(x, n, dim)
    return parts[i] if i < len(parts) else x.narrow(dim, 0, 0)


def _rest_grad(g: torch.Tensor, rest: Resting,
               keep_model: bool = False) -> torch.Tensor:
    """A leaf's full gradient from this rank's rows -> the global
    gradient's shard in the leaf's resting layout: over each batch axis
    a reduce-scatter on the dim the leaf shards there (an all-reduce,
    then this rank's piece, where the dim does not divide; an all-reduce
    where the leaf is replicated), over 'model' this rank's piece
    without communication (every rank of it holds the same gradient).
    With ``keep_model`` ``g`` is the gradient of the leaf's model shard
    already (it was gathered over the batch axes only): nothing is
    taken over 'model'."""
    mesh = rest.mesh
    batch = sharding.batch_axes(mesh)
    for name, p in zip(mesh.mesh_dim_names, rest.placements):
        group = mesh.get_group(name)
        n = dist.get_world_size(group)
        i = mesh.get_local_rank(name)
        if name in batch and n > 1:
            if p.is_shard() and g.shape[p.dim] % n == 0:
                x = g.movedim(p.dim, 0).contiguous()
                out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
                _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=group)
                g = out.movedim(0, p.dim)
                continue
            g = g.clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        if p.is_shard() and not (keep_model and name == "model"):
            g = _chunk(g, p.dim, n, i)
    return g.contiguous()


class _GatherRest(torch.autograd.Function):
    """A :class:`Resting` leaf gathered whole (or, with ``keep_model``,
    over every mesh dim but 'model'); the backward is
    :func:`_rest_grad`."""

    @staticmethod
    def forward(ctx, local, rest, keep_model):
        ctx.rest, ctx.keep_model = rest, keep_model
        x = DTensor.from_local(local.detach(), rest.mesh, rest.placements,
                               run_check=False, shape=rest.shape,
                               stride=rest.stride)
        out = _gathered(x, keep_model)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return _rest_grad(g, ctx.rest, ctx.keep_model), None, None


def _leaf_plan(x, keep_model: bool):
    """``(run, fixed)`` of one leaf: ``run(x)`` its local tensor for
    compute (its model shard kept with ``keep_model``); ``fixed`` where
    nothing moves (a plain tensor, or a DTensor in its :func:`_want`
    placements already: its local tensor, a view of the resting
    shard)."""
    if isinstance(x, Resting):
        return (lambda r: _GatherRest.apply(r.local, r, keep_model)), False
    if not isinstance(x, DTensor):
        return (lambda v: v), True
    want = _want(x, keep_model)
    if want == list(x.placements):
        return (lambda v: v.to_local()), True
    return (lambda v: v.redistribute(v.device_mesh, want).to_local()), False


def _plan(node, keep_model: bool):
    """:func:`localize`'s walk of ``node`` worked out once: ``(run,
    fixed)``, ``run(node)`` the node as local tensors (which leaves keep
    their model shard and their placements decided here), ``fixed``
    where no leaf of it moves."""
    if isinstance(node, list):
        items = [_plan(v, keep_model) for v in node]
        return ((lambda n: [f(v) for (f, _), v in zip(items, n)]),
                all(fixed for _, fixed in items))
    if not isinstance(node, dict):
        return _leaf_plan(node, False)
    make, mesh, lo = dict, None, 0
    w = node.get("w_q", node.get("w"))
    bank = next((node[k] for k in ("gate_q", "gate") if k in node), None)
    if isinstance(w, DTensor) and w.ndim == 2:
        column = keep_model and _split(w) and _model_shard_dim(w) == 1 \
            and _divides(w, 1)
        parts = {k: _leaf_plan(v, column) for k, v in node.items()}
        if column:
            make, mesh = ColumnShard, w.device_mesh
    elif isinstance(bank, DTensor) and bank.ndim == 3 and keep_model \
            and _split(bank) and _model_shard_dim(bank) == 0 \
            and _divides(bank, 0):
        banks = {f"{b}{s}" for b in _BANKS for s in ("", "_q", "_scale")}
        parts = {k: (_leaf_plan(v, True) if k in banks
                     else _plan(v, keep_model)) for k, v in node.items()}
        make, mesh = ExpertShard, bank.device_mesh
        lo = mesh.get_local_rank("model") * (bank.shape[0]
                                             // _model_size(mesh))
    else:
        parts = {k: _plan(v, keep_model) for k, v in node.items()}

    def run(n):
        out = make({k: f(n[k]) for k, (f, _) in parts.items()})
        if make is not dict:
            out.mesh = mesh
            if make is ExpertShard:
                out.lo = lo
        return out
    return run, all(fixed for _, fixed in parts.values())


def localize(tree, *, keep_model: bool = True):
    """The parameter tree as this rank's local tensors for compute (see
    the module docstring).  A column-parallel linear or an expert bank
    whose model-sharded dim does not divide is gathered whole, as JAX's
    constraints skip such a dim."""
    return _plan(tree, keep_model)[0](tree)


def gather_block(tree):
    """A block's (or any subtree's) resting parameters -> local tensors
    for compute by :func:`localize`'s rules (the scope's
    ``keep_model``); the identity outside :func:`scope`.  Call it where
    the block runs and pass the result straight on, so no reference
    keeps the gathered tensors past the block.  The subtree's plan is
    worked out at its first gather in the scope; a step then only runs
    the collectives, and a subtree where nothing moves (every mesh dim
    it is split over of size one) returns the same views every step."""
    s = _SCOPE.get()
    if s is None:
        return tree
    return _run_plan(s, id(tree), tree, lambda: _plan(tree, s.keep_model))


def _run_plan(s: _Scope, key, tree, make):
    """``tree`` gathered by the scope's plan under ``key``, worked out by
    ``make()`` at the first gather of this subtree in the scope."""
    hit = s.plans.get(key)
    if hit is None or hit[0] is not tree:
        run, fixed = make()
        hit = s.plans[key] = (tree, run, run(tree) if fixed else None)
    return hit[1](tree) if hit[2] is None else hit[2]


def _splits_d(t) -> bool:
    """Whether the embedding table ``t`` (a DTensor, or a
    :class:`Resting` leaf) rests with its d dim split in equal parts
    over more than one 'model' rank."""
    if isinstance(t, Resting):
        mesh, placements, shape = t.mesh, t.placements, t.shape
    elif isinstance(t, DTensor):
        mesh, placements, shape = t.device_mesh, t.placements, t.shape
    else:
        return False
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return False
    m = _model_size(mesh)
    p = placements[names.index("model")]
    return m > 1 and p.is_shard() and p.dim == 1 and shape[1] % m == 0


def gather_table(p: dict) -> dict:
    """The embedding's resting params -> ``{"table": ...}`` for the token
    lookup: this rank's model shard ``[V, d/m]`` of the table, as JAX
    lays it out (``embed_sharded``: the lookup is shard-local); over the
    batch axes only what the table's placement shards there moves.  Rows
    looked up in it are this rank's d-chunk of the stream
    (:func:`model_whole` makes them whole).  In training the backward
    gives the shard's gradient summed over the batch axes.  A table whose
    d does not split in equal parts over 'model' is gathered whole, as
    :func:`gather_block` gathers it (which the tied head reads).  The
    identity outside :func:`scope`."""
    s = _SCOPE.get()
    if s is None:
        return p

    def make():
        t = p["table"]
        run, fixed = _leaf_plan(t, _splits_d(t))
        return (lambda n: {"table": run(n["table"])}), fixed
    return _run_plan(s, ("table", id(p)), p, make)


class _ToShard(torch.autograd.Function):
    """A replicated activation -> this rank's chunk of ``dim`` over
    'model', a copy of its own (no communication); the backward
    all-gathers the gradient's chunks."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        part = _chunk(x, dim, _model_size(mesh), mesh.get_local_rank("model"))
        return part.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _model_gather(g, ctx.mesh, ctx.dim), None, None


class _ToWhole(torch.autograd.Function):
    """This rank's chunk of ``dim`` -> the chunks of 'model' all-gathered;
    the backward keeps this rank's chunk of the gradient (every rank of
    'model' holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return _chunk(g, ctx.dim, _model_size(mesh),
                      mesh.get_local_rank("model")).contiguous(), None, None


def model_shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A replicated activation -> this rank's chunk of ``dim`` over the
    scope's 'model' axis (its backward all-gathers).  ``x`` itself
    outside :func:`scope`, on a model axis of one, or where ``dim`` does
    not divide (as JAX's constraint skips it)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    m = _model_size(mesh)
    if m == 1 or x.shape[dim] % m:
        return x
    return _ToShard.apply(x, mesh, dim % x.ndim)


def model_whole(x: torch.Tensor, width: int) -> torch.Tensor:
    """The residual stream ``[..., width]``: ``x`` itself where it is
    whole, else this rank's d-chunk (of :func:`model_shard` or a lookup
    in :func:`gather_table`'s shard) all-gathered over the scope's
    'model' axis (its backward keeps this rank's chunk)."""
    if x.shape[-1] == width:
        return x
    return _ToWhole.apply(x, current_mesh(), x.ndim - 1)


class SeqShard(dict):
    """A layer's KV cache (``k``, ``v``, ``len`` and an int8 cache's
    scales) whose ``[B, S/m, ...]`` leaves hold this rank's positions
    ``offset`` to ``offset + S/m`` of a sequence split over the 'model'
    axis of ``mesh``; ``len`` is the global length."""

    mesh = None
    offset = 0


class StateShard(dict):
    """A layer's recurrent state whose leaf ``name`` holds this rank's
    slice of dim ``dims[name]`` over the 'model' axis of ``mesh``."""

    mesh = None
    dims: dict = {}


class CacheShards(dict):
    """A decode step's caches as this rank's shards (:func:`split_caches`):
    ``split`` maps a leaf's path (``"kv/k"``, ``"ssm/ssm"``,
    ``"cross_k"``) to its dim split over 'model'."""

    mesh = None
    split: dict = {}


def _axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def split_caches(caches: dict, mesh, cfg, *, seq_shard: bool = True
                 ) -> dict:
    """Caches of this rank's batch rows (as the mesh serve holds them)
    -> its shards over 'model' as ``sharding.cache_specs(...,
    seq_shard=seq_shard)`` lays them out: the KV sequence (and int8
    scales, and cross K/V) where it divides, SSM states their heads.  A
    leaf that does not divide stays whole, as there.  Returns a
    :class:`CacheShards`."""
    m = _model_size(mesh)
    i = mesh.get_local_rank("model") if "model" in tuple(
        mesh.mesh_dim_names) else 0
    # Only the 'model' entries are read: the batch dim is split already.
    specs = sharding.cache_specs(mesh, caches, cfg, 1, seq_shard=seq_shard)
    out = CacheShards()
    out.mesh, out.split = mesh, {}

    def walk(path, node, spec):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}" if path else k, v, spec[k])
                    for k, v in node.items()}
        dim = next((d for d, e in enumerate(spec.spec)
                    if "model" in _axes(e)), None)
        if dim is None:
            return node
        out.split[path] = dim
        if m == 1:
            return node
        return _chunk(node, dim, m, i).clone()

    out.update(walk("", caches, specs))
    return out


def _seq_shard(view: dict, mesh) -> SeqShard:
    out = SeqShard(view)
    out.mesh = mesh
    out.offset = mesh.get_local_rank("model") * view["k"].shape[1]
    return out


def layer_cache(caches: dict, group: str, i: int) -> dict:
    """Layer ``i``'s view ``{name: leaf[i]}`` of ``caches[group]``
    (``"kv"`` or ``"ssm"``; in-place writes land in the stacked leaves),
    a :class:`SeqShard` / :class:`StateShard` where ``caches`` is a
    :class:`CacheShards` that splits the group's leaves."""
    node = caches[group]
    view = {name: t[i] for name, t in node.items()}
    if not isinstance(caches, CacheShards):
        return view
    dims = {name: caches.split[f"{group}/{name}"] - 1 for name in node
            if f"{group}/{name}" in caches.split}
    if not dims:
        return view
    if group == "kv":
        return _seq_shard(view, caches.mesh)
    out = StateShard(view)
    out.mesh, out.dims = caches.mesh, dims
    return out


def cross_cache(caches: dict, i: int) -> dict:
    """Layer ``i``'s cross K/V ``{k, v}`` (a :class:`SeqShard` where its
    frames are split)."""
    view = {"k": caches["cross_k"][i], "v": caches["cross_v"][i]}
    if isinstance(caches, CacheShards) and "cross_k" in caches.split:
        return _seq_shard(view, caches.mesh)
    return view


def gather_state(state):
    """A layer's recurrent state -> whole (a :class:`StateShard`'s leaves
    all-gathered over 'model'); others pass through."""
    if not isinstance(state, StateShard):
        return state
    return {name: (_model_gather(t, state.mesh, state.dims[name])
                   if name in state.dims else t)
            for name, t in state.items()}


def state_shard(state, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole new state leaf ``name`` in
    ``state``'s layout."""
    if not isinstance(state, StateShard) or name not in state.dims:
        return full
    m = _model_size(state.mesh)
    return _chunk(full, state.dims[name], m,
                  state.mesh.get_local_rank("model"))


def _model_gather(y: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """All-gather ``y`` (equal shards) along ``dim`` over 'model'."""
    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    if n == 1:
        return y
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim)


def gather_columns(y, p: ColumnShard):
    """A column-parallel linear's local output -> its full width (a
    QTensor's int8 codes; its scale is per tensor)."""
    from repro_torch.core import quant
    if isinstance(y, quant.QTensor):
        return quant.QTensor(_model_gather(y.q, p.mesh, -1), y.scale)
    return _model_gather(y, p.mesh, y.ndim - 1)


def gather_experts(y: torch.Tensor, p: ExpertShard) -> torch.Tensor:
    """This rank's experts' outputs ``[E/m, ...]`` -> all ``[E, ...]``."""
    return _model_gather(y, p.mesh, 0)


def batch_max(x: torch.Tensor, p=None) -> torch.Tensor:
    """The max of ``x`` over the ranks of the scope's batch axes (and of
    'model' when ``p`` is an :class:`ExpertShard`): a per-tensor
    quantization scale is the global batch's (the qat activation scale,
    the MoE down bank's activation scale over every expert's buffer).
    ``x`` itself outside :func:`scope`."""
    mesh = current_mesh()
    groups = [] if mesh is None else _batch_groups(mesh)
    if isinstance(p, ExpertShard):
        groups.append(p.mesh.get_group("model"))
    groups = [g for g in groups if dist.get_world_size(g) > 1]
    if not groups:
        return x
    x = x.detach().clone()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def _batch_groups(mesh) -> list:
    return [mesh.get_group(a) for a in sharding.batch_axes(mesh)
            if a in tuple(mesh.mesh_dim_names)]


def batch_size(mesh) -> int:
    n = 1
    for g in _batch_groups(mesh):
        n *= dist.get_world_size(g)
    return n


def batch_sum(x: torch.Tensor, mesh=None, *, grad: bool = False
              ) -> torch.Tensor:
    """Sum of ``x`` over the batch axes of ``mesh`` (the scope's when
    None); ``grad`` makes it differentiable (its backward sums the
    cotangents the same way)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return x
    for g in _batch_groups(mesh):
        if dist.get_world_size(g) == 1:
            continue
        if grad:
            x = _SumOver.apply(x, g)
        else:
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


class _SumOver(torch.autograd.Function):
    """All-reduce SUM over ``group`` whose backward sums the cotangents
    the same way (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over its batch rows -> the global batch's mean (all
    ranks hold equal row counts); the identity outside :func:`scope`."""
    mesh = current_mesh()
    if mesh is None or batch_size(mesh) == 1:
        return x
    return batch_sum(x, mesh, grad=True) / batch_size(mesh)


def local_batch(batch: dict, mesh) -> dict:
    """The global batch (the same on every rank) -> this rank's rows, as
    ``sharding.data_specs`` lays it out (``length`` and other scalars
    pass through)."""
    tensors = {k: v for k, v in batch.items()
               if isinstance(v, torch.Tensor) and v.ndim > 0}
    specs = sharding.data_specs(mesh, tensors)
    out = dict(batch)
    for k, v in tensors.items():
        out[k] = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False).redistribute(
            mesh, specs[k].placements).to_local()
    return out


def gather_batch(x: torch.Tensor, mesh, *, global_rows: int,
                 dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch-major output -> the global batch on
    every rank (the rows were split as :func:`local_batch` splits a
    batch of ``global_rows``)."""
    spec = [None] * x.ndim
    spec[dim] = sharding.data_specs(
        mesh, {"x": torch.empty(global_rows)})["x"].spec[0]
    placements = sharding.NamedSharding(mesh, tuple(spec)).placements
    if all(p.is_replicate() for p in placements):
        return x
    shape = list(x.shape)
    shape[dim] = global_rows
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride()).full_tensor()


def as_dtensor(local: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's shard -> a DTensor laid out like ``like``."""
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def replication(x: DTensor) -> int:
    """How many ranks hold each element of ``x``."""
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if not p.is_shard():
            n *= size
    return n


def global_norm(locals_: list, likes: list) -> torch.Tensor:
    """The global L2 norm of a sharded tree from each rank's shards: per
    leaf the local sum of squares over its replication, then one
    all-reduce over the whole mesh (on one rank: the single-device
    ``optimizer.global_norm`` in its order)."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) / replication(l)
            for x, l in zip(locals_, likes)]
    total = torch.sum(torch.stack(sums))
    # The mesh spans the whole process group.
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return torch.sqrt(total)
