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
  axes) and are replicated over 'model'.  A column-parallel linear
  (:class:`ColumnShard`) computes its local columns -- K1's epilogue is
  per column, so they are the full product's -- and all-gathers them
  over 'model'; the expert banks (:class:`ExpertShard`) run this rank's
  experts and all-gather their outputs.
* Reductions over the global batch (the MoE balance loss's means, the
  loss's token count, the gradients) are all-reduced over the batch
  axes; :func:`batch_mean` is the identity outside :func:`scope`.

* **Memory**: :func:`localize` gathers the whole tree at once, at the
  start of each ``static_generate`` call and each train step, so every
  rank holds the whole model's weights at compute precision beside its
  resting shards (and, training, the full gradients, all-reduced before
  :func:`to_rest` keeps its shard).  The mesh splits the optimizer state
  and the batch, not the weights' peak: a model whose weights (serving)
  or weights and gradients (training) do not fit one card does not fit
  this path either.

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


@contextlib.contextmanager
def scope(mesh):
    """Run the model code inside on ``mesh`` (its batch reductions
    all-reduce over the batch axes)."""
    token = _SCOPE.set(mesh)
    try:
        yield mesh
    finally:
        _SCOPE.reset(token)


def current_mesh():
    return _SCOPE.get()


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


def _gathered(x: DTensor, keep_model: bool) -> torch.Tensor:
    """``x`` replicated on every mesh dim but, with ``keep_model``,
    'model'; as this rank's local tensor."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    want = [p if (keep_model and n == "model") else Replicate()
            for n, p in zip(names, x.placements)]
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
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


def _divides(x: DTensor, dim: int) -> bool:
    return x.shape[dim] % _model_size(x.device_mesh) == 0


_BANKS = ("gate", "up", "down")


def localize(tree, *, keep_model: bool = True):
    """The parameter tree as this rank's local tensors for compute (see
    the module docstring).  A column-parallel linear or an expert bank
    whose model-sharded dim does not divide is gathered whole, as JAX's
    constraints skip such a dim."""
    def leaf(x):
        return _gathered(x, False) if isinstance(x, DTensor) else x

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return leaf(node)
        w = node.get("w_q", node.get("w"))
        if isinstance(w, DTensor) and w.ndim == 2:
            d = _model_shard_dim(w)
            if keep_model and d == 1 and _divides(w, 1):
                out = ColumnShard({k: _gathered(v, True) for k, v in
                                   node.items()})
                out.mesh = w.device_mesh
                return out
            return {k: leaf(v) for k, v in node.items()}
        bank = next((node[k] for k in ("gate_q", "gate") if k in node),
                    None)
        if isinstance(bank, DTensor) and bank.ndim == 3:
            if keep_model and _model_shard_dim(bank) == 0 \
                    and _divides(bank, 0):
                banks = {f"{b}{s}" for b in _BANKS
                         for s in ("", "_q", "_scale")}
                out = ExpertShard({k: (_gathered(v, True) if k in banks
                                       else walk(v))
                                   for k, v in node.items()})
                mesh = bank.device_mesh
                m = _model_size(mesh)
                out.mesh = mesh
                out.lo = mesh.get_local_rank("model") * (bank.shape[0] // m)
                return out
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


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


def to_rest(g: torch.Tensor, like: DTensor) -> torch.Tensor:
    """A replicated full tensor -> this rank's shard in ``like``'s layout
    (no communication)."""
    mesh = like.device_mesh
    return DTensor.from_local(g, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, like.placements).to_local()


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
