"""Cost counting of the port's eager step: the counterpart of the JAX
package's ``repro/roofline/hlo_parse.py``, which reads the same figures
from optimized HLO text.

:class:`OpCounter` is a ``TorchDispatchMode``: every aten op the step
runs passes through it, on real tensors or on fake ones
(``FakeTensorMode``), and :meth:`OpCounter.aggregate` returns JAX's dict
(``flops``, ``traffic_bytes``, ``collectives``, ``unknown_trip_loops``,
``top_ops``, items as JAX's) plus ``kernels``, the records of the
hand-written kernels:

* ``flops``: matmul-family work only, as JAX counts dots and ignores
  elementwise ops: mm, addmm, bmm, baddbmm, convolution and the SDPA ops,
  by ``torch.utils.flop_counter``'s formulas, plus each kernel record's
  operations (``2 M K N`` for K1, the same per bit plane for K4, the q.k
  and p.v products of K2/K3).
* ``traffic_bytes``: eager PyTorch writes every op's output to device
  memory, so each op that is not a view charges the bytes of its tensor
  inputs and outputs (an in-place op's output too); views (view,
  reshape-as-view, transpose, permute, expand, slice, select, squeeze,
  unsqueeze, detach, alias), allocations without a write (``empty``)
  and copies between host and card (a tensor made from Python data
  reaches the card without passing the dispatcher) are free.  A kernel
  record charges its compulsory bytes: each operand read once, the
  output written once.  This is the traffic of the path
  as it runs today, op by op; JAX's figure is XLA's estimate at fusion
  boundaries, so the two differ by what a fuser would keep on chip.
* ``collectives``: one record per collective op, the functional ops
  (``_c10d_functional.*``, which DTensor's ``redistribute`` issues) and
  the plain c10d ops (``dist.all_gather`` reaches ``c10d.allgather_``),
  with g the op's group size, folded by
  ``analysis.collective_bytes_from_records``.
* ``unknown_trip_loops`` is always 0: Python runs every layer and every
  microbatch, so the count is loop-aware by construction.

A kernel wrapper records its work at its public entry, whichever arm
runs (the CUDA kernel, the plain twin, or the shape-only arm of a fake
tensor), through :func:`shape_only`, which also hides the wrapper's own
aten ops from the counter.  So a trace of the CPU path and a trace of the
card's path count the same work, and a real run on the card counts what
a fake trace counts.

The counter also follows the bytes of the storages a step allocates
(per device, CUDA sizes rounded up to the caching allocator's 512-byte
blocks) and keeps their peak.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline import analysis

# Counters entered, innermost last (read by the kernel wrappers).
ACTIVE: list = []

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
         "alias", "wait_tensor", "device", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "set_",
         "record_stream", "resize_"}

# JAX's kinds of the functional and the plain c10d collectives.
_COLL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLL_NS = ("_c10d_functional", "c10d_functional", "c10d")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_tag(t) -> str:
    dt = str(t.dtype).removeprefix("torch.")
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


def shape_only(name: str, work, fake_out):
    """Decorate the kernel wrapper ``fn`` for counting and fake tensors.

    When its first argument is a ``FakeTensor`` the call goes to
    ``fake_out`` (same arguments) in place of ``fn``: the shape-only arm,
    an empty output of the kernel's shape and dtype on the input's device
    (and whatever scratch the kernel allocates), which never reads a data
    pointer, asks for the card's SM count, builds a kernel or counts a
    launch.  When a counter runs, the call, fake or real, is recorded
    into the innermost counter (``work(*args, **kwargs)`` gives ``(ops,
    bytes, tag)``: the kernel's operations and compulsory bytes) and the
    aten ops run inside are hidden from it; a call nested in another
    kernel's record (a wrapper calling its kernel function) is not
    recorded again, and a call that raises records nothing.  Otherwise
    ``fn`` runs as it is, after one ``isinstance`` check: a real tensor
    launches the kernel or raises, as before."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fake = isinstance(args[0], FakeTensor)
            if not (fake or ACTIVE):
                return fn(*args, **kwargs)
            run = fake_out if fake else fn
            c = ACTIVE[-1] if ACTIVE else None
            if c is None or c._hidden:
                return run(*args, **kwargs)
            ops, n_bytes, tag = work(*args, **kwargs)
            c._hidden += 1
            try:
                out = run(*args, **kwargs)
            finally:
                c._hidden -= 1
            c.add_kernel(name, ops, n_bytes, tag)
            return out
        return wrapper
    return deco


def _group_size(name: str, args) -> int:
    """g of a collective op: the functional ops name their group (and
    some its size), the c10d ops pass the ProcessGroup object."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return torch._C._distributed_c10d.ProcessGroup.unbox(
                    a).size()
            except Exception:          # not a process group (a ReduceOp)
                continue
    if name in ("send", "recv_"):
        return 2
    from torch.distributed import distributed_c10d
    for a in reversed(args):
        if isinstance(a, str):
            return distributed_c10d._resolve_process_group(a).size()
    return 1


def _tensors(x, acc: list) -> list:
    """The tensors of an op's (nested tuple / list / dict) arguments."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, acc)
    return acc


@functools.cache
def _op_info(func) -> tuple:
    """(name, namespace, free of traffic, outputs are new storages,
    collective kind or None, flop formula or None) of an aten op."""
    packet = func._overloadpacket
    name, ns = packet.__name__, func.namespace
    schema = func._schema
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    aliases = any(r.alias_info is not None for r in schema.returns)
    free = ns == "prim" or func.is_view or name in _FREE
    fresh = not (writes or aliases or func.is_view)
    coll = _COLL.get(name) if ns in _COLL_NS else None
    return (name, ns, free, fresh, coll,
            flop_counter.flop_registry.get(packet))


def _alloc_bytes(t: torch.Tensor, n: int) -> int:
    if t.device.type == "cuda":
        return -(-n // 512) * 512
    return n


class OpCounter(TorchDispatchMode):
    """Counts a step's flops, traffic bytes, collectives and kernel
    records (see the module docstring).  Enter it around the step; read
    :meth:`aggregate` after.

    It also follows the bytes of the storages the step allocates, live
    and at their peak, per device (:meth:`peak_bytes`): each new output
    storage (an op's output that is neither a view nor written in place)
    adds its size, on CUDA rounded up to the caching allocator's 512
    bytes, until it is freed; storages made before (the step's
    arguments) are not counted.  The kernels' own allocations count here
    too (the shape-only arm allocates what the kernel does)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll_records: list = []
        self.kernels: dict = {}
        self.live: collections.Counter = collections.Counter()
        self.peak: collections.Counter = collections.Counter()
        self._items: collections.Counter = collections.Counter()
        self._seen: set = set()
        self._hidden = 0

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, ops: float, n_bytes: float, tag: str):
        k = self.kernels.setdefault(name, {"records": 0, "ops": 0.0,
                                           "bytes": 0.0})
        k["records"] += 1
        k["ops"] += float(ops)
        k["bytes"] += float(n_bytes)
        self.flops += float(ops)
        self.traffic += float(n_bytes)
        self._items[("dot", float(ops), f"{tag} @ {name}")] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = _op_info(func)
        if info[3]:
            self._allocated(out)
        if not self._hidden:
            self._count(info, args, kwargs, out)
        return out

    def _allocated(self, out):
        for t in _tensors(out, []):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = _alloc_bytes(t, st.nbytes())
            dev = str(t.device)
            self._seen.add(key)
            self.live[dev] += n
            if self.live[dev] > self.peak[dev]:
                self.peak[dev] = self.live[dev]
            weakref.finalize(st, self._free, key, dev, n)

    def _free(self, key, dev, n):
        self._seen.discard(key)
        self.live[dev] -= n

    def peak_bytes(self) -> int:
        """The largest per-device peak of the step's allocations."""
        return max(self.peak.values(), default=0)

    def _count(self, info, args, kwargs, out):
        name, ns, free, _, kind, flop = info
        if kind is not None:
            outs = _tensors(out, [])
            if name.endswith("_") or not outs:
                # The c10d ops write into their first argument.
                outs = _tensors(args[0], [])
            per_shard = sum(nbytes(t) for t in outs)
            g = _group_size(name, args)
            self.coll_records.append((kind, per_shard, g))
            self._items[(kind, float(per_shard * g
                                     * analysis.ring_factor(kind, g)),
                         f"{_shape_tag(outs[0]) if outs else ''} g={g} @ "
                         f"{ns}.{name}")] += 1
        if flop is not None:
            fl = float(flop(*args, **kwargs, out_val=out))
            self.flops += fl
            t = out[0] if isinstance(out, (tuple, list)) else out
            self._items[("dot", fl, f"{_shape_tag(t)} @ {name}")] += 1
        if free:
            return
        ts = _tensors((args, kwargs, out), [])
        if name in ("_to_copy", "copy_") and len({t.device for t in ts}) > 1:
            return      # a copy between host and card: a tensor made from
                        # Python data reaches the card outside the
                        # dispatcher, so only a trace would see it
        self.traffic += float(sum(nbytes(t) for t in ts))

    def aggregate(self) -> dict:
        """JAX's ``hlo_parse.aggregate`` dict of the counted step, plus
        ``kernels`` ``{name: {records, ops, bytes}}``."""
        top = [{"kind": k, "total": v * m, "mult": float(m), "tag": t}
               for (k, v, t), m in self._items.items()]
        top.sort(key=lambda d: -d["total"])
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic,
            "collectives": analysis.collective_bytes_from_records(
                self.coll_records),
            "unknown_trip_loops": 0,
            "top_ops": top[:40],
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }
