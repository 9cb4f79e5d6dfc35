"""Meshes and the process group under them (port of
``repro/launch/mesh.py``).

JAX builds its meshes over the devices one process sees; the port runs
one process per device, so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is running: :func:`init_group` starts it (``nccl`` with one card per
rank on ``cuda``; ``gloo`` on ``cpu``, the counterpart of JAX's forced
host devices) and :func:`spawn` starts N such ranks from one command.
``--devices N`` on ``cuda`` with fewer cards than N raises: the port
never carries on over CPU ranks.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def production_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axis names): 16 x 16 = 256 devices a pod; 2 pods = 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def axes_for(shape) -> tuple:
    """The axis names of a 2-d or 3-d mesh shape."""
    if len(shape) == 2:
        return ("data", "model")
    if len(shape) == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh shape has 2 or 3 dims, got {tuple(shape)}")


def shape_and_count(mesh_shape: str | None, devices: int | None) -> tuple:
    """(mesh shape, rank count) of the launchers' ``--mesh-shape`` (``d,m``
    or ``p,d,m``) and ``--devices``: a shape alone takes its product, a
    count alone the shape ``N,1``."""
    if mesh_shape is not None:
        shape = tuple(int(x) for x in mesh_shape.split(","))
    else:
        shape = (devices, 1)
    n = devices if devices is not None else math.prod(shape)
    if math.prod(shape) != n:
        raise ValueError(f"--mesh-shape {mesh_shape} has "
                         f"{math.prod(shape)} devices, --devices {n}")
    axes_for(shape)
    return shape, n


def local_ranks(n: int) -> int:
    """The ranks of an ``n``-rank group that run on this node: a
    launcher's (torchrun's) ``LOCAL_WORLD_SIZE`` when it started the ranks
    (``WORLD_SIZE`` is set), else all ``n`` (the port spawns them here)."""
    if "WORLD_SIZE" not in os.environ:
        return n
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))


def check_devices(n: int, device, *, local: int | None = None) -> None:
    """Raise unless this node's ranks of an ``n``-rank group (``local``,
    by default :func:`local_ranks`) fit on ``device``'s kind: one card
    each on CUDA (NCCL allows no two ranks on one card)."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = local_ranks(n) if local is None else local
    if local <= have:
        return
    if local == n:
        need = f"needs {n} CUDA devices (one per rank)"
    else:
        need = (f"puts {local} of its ranks on this node, which needs "
                f"{local} CUDA devices (one per rank),")
    raise RuntimeError(
        f"--devices {n} {need} but {have} are visible; a run on the card "
        "needs N cards (pass --device cpu for gloo ranks on the CPU)")


def init_group(device="cuda", *, rank: int | None = None,
               world_size: int | None = None,
               init_method: str | None = None,
               timeout_s: float = 300.0) -> torch.device:
    """Join (or start) the default process group: ``nccl`` with
    ``cuda:<local rank>`` when ``device`` is CUDA, ``gloo`` on the CPU.
    ``rank`` / ``world_size`` / ``init_method`` default to the
    ``RANK`` / ``WORLD_SIZE`` / ``env://`` of a launcher such as
    torchrun.  Returns this rank's device."""
    dev_type = torch.device(device).type
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    check_devices(world_size, dev_type)
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev_type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": dev} if dev_type == "cuda" else {}))
    return dev


def make_mesh(shape, axes=None, device="cuda"):
    """A DeviceMesh of ``shape`` (axis names ``axes``, by default
    :func:`axes_for`) over the running group, whose size must be the
    shape's product."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(shape)
    axes = tuple(axes) if axes is not None else axes_for(shape)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512 ranks)."""
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device="cuda"):
    """The small ``(data, model)`` mesh of the tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def _child(rank, n, device, store, fn, args, results, threads):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(threads)
        init_group(device, rank=rank, world_size=n,
                   init_method=f"file://{store}", timeout_s=120.0)
        out = fn(rank, *args)
        dist.barrier()
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:                      # report, then exit non-zero
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n: int, *, device="cpu", args=(), timeout_s: float = 300.0,
          threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` on ``n`` fresh ranks of one process group
    (``init_group`` in each, a FileStore in a temporary directory) and
    return their results by rank (picklable values).  A rank that raises
    fails the call with its traceback; ranks still running after
    ``timeout_s`` are killed and the call raises ``TimeoutError``.
    ``fn`` must be importable by name (a module-level function)."""
    check_devices(n, device, local=n)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(
            r, n, device, store, fn, args, results, threads), daemon=True)
            for r in range(n)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{n - len(got)} of {n} ranks still running after "
                        f"{timeout_s:.0f} s")
                try:
                    rank, status, payload = results.get(timeout=min(left,
                                                                    1.0))
                except queue_lib.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        # Give a failing rank's report a moment to arrive.
                        time.sleep(0.5)
                        if results.empty():
                            raise RuntimeError(
                                f"rank process exited with code "
                                f"{dead[0].exitcode} without a result")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n)]


def init_fake_group(world_size: int) -> None:
    """Start the default process group as rank 0 of ``world_size`` ranks
    of PyTorch's fake backend: collectives complete at once and move
    nothing, so one process traces what rank 0 of a production mesh runs
    (the dry run).  Raises if a group is already running (a process holds
    one default group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the fake "
                           "group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_fake_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh (16 x 16, or 2 x 16 x 16) over a fake group of
    256 or 512 ranks that this call starts, as a DeviceMesh on
    ``device``'s type (the counterpart of the JAX package's
    ``make_production_mesh`` over 512 forced host devices)."""
    shape, axes = production_shape(multi_pod=multi_pod)
    init_fake_group(math.prod(shape))
    return make_mesh(shape, axes, device)
