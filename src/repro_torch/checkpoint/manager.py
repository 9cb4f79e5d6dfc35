"""Atomic, async, keep-k checkpoints in the JAX package's on-disk layout
(port of ``repro/checkpoint/manager.py``)::

    <dir>/step_000123/
        manifest.json    {step, time, leaves: path -> {shape, dtype}}
        arrays.npz       the flattened tree, keys are '/'-joined paths
    <dir>/LATEST         text file: "step_000123"  (atomic pointer)

* **Atomicity**: a step is written to ``step_X.tmp-<pid>`` and renamed;
  ``LATEST`` moves only after the rename, so a crash mid-save never
  corrupts the restore point.
* **Async**: ``save_async`` copies the tree to host memory before its
  thread starts, then writes the file in the background.
* **keep-k**: older step directories are pruned after a save.
* **bfloat16** leaves are stored as JAX stores them: a ``uint16`` payload
  with ``"bfloat16"`` as the manifest dtype (no ``ml_dtypes`` needed), so
  a checkpoint of either package restores in the other.

* **Meshes**: a tree of DTensors (``distributed/sharding.py``) is saved
  as full arrays (every rank takes part in the gather; rank 0 writes), so
  it restores on one device or onto another mesh shape (elastic
  restore): :meth:`CheckpointManager.restore` with ``shardings`` lays
  each leaf out for the mesh that is running.

Paths follow the tree: dict keys, and list indices for the port's
per-layer lists (``params/stack/blocks/0/attn/q/w``).  A JAX checkpoint
stacks its layers (``params/stack/blocks/attn/q/w`` ``[L, ...]``);
:meth:`CheckpointManager.load_flat` reads it by path and
``convert.train_state_from_jax`` turns it into the port's trees.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import device as device_lib


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten_like(template, flat: dict):
    def build(prefix, node):
        if isinstance(node, dict):
            return {k: build(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [build(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(seq) if isinstance(node, tuple) else seq
        return flat[prefix]

    return build("", template)


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as (numpy payload, manifest dtype name): bfloat16 as its
    uint16 bit pattern."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of :func:`_to_host`."""
    a = np.require(a, requirements="C")
    if dtype == "bfloat16":
        return torch.from_numpy(a.reshape(-1).view(np.int16)).view(
            torch.bfloat16).reshape(a.shape)
    if str(a.dtype) != dtype:
        raise ValueError(f"payload {a.dtype} does not hold dtype {dtype!r}")
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save ---
    def save(self, step: int, tree) -> str:
        host = _host_flat(tree)
        path = self._write(step, host) if _writer() else None
        _barrier()
        return path

    def save_async(self, step: int, tree) -> None:
        self._join()  # one outstanding save at a time
        host = _host_flat(tree)   # snapshot now
        if not _writer():
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        """The outstanding save is on disk (for every rank of a process
        group: they wait for rank 0)."""
        self._join()
        _barrier()

    def _write(self, step: int, flat: dict) -> str:
        name = f"step_{step:09d}"
        final = os.path.join(self.dir, name)
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                       for k, (a, dt) in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(name)
        os.rename(os.path.join(self.dir, "LATEST.tmp"),
                  os.path.join(self.dir, "LATEST"))
        self._prune()
        return final

    def _prune(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def latest_step(self) -> int | None:
        pointer = os.path.join(self.dir, "LATEST")
        if not os.path.exists(pointer):
            return None
        with open(pointer) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def load_flat(self, step: int) -> dict:
        """Every leaf of step ``step`` by path, as CPU tensors of the
        manifest's dtypes."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return {k: _from_host(z[k], manifest["leaves"][k]["dtype"])
                    for k in z.files}

    def restore(self, step: int, template, shardings=None, *,
                device="cuda"):
        """Step ``step`` in ``template``'s tree structure (its leaves are
        not read), on ``device``.  ``shardings`` (a matching tree of
        ``sharding.NamedSharding``, None for a leaf to keep whole) lays
        each leaf out for the mesh that is running."""
        dev = device_lib.resolve(device)
        flat = self.load_flat(step)
        # A copy into the allocator's own (aligned) memory: the CPU's
        # matmul kernels may take another summation path for a buffer
        # that np.load placed at another alignment.
        tree = _unflatten_like(template, {k: v.to(dev, copy=True)
                                          for k, v in flat.items()})
        if shardings is None:
            return tree
        from repro_torch.distributed import sharding
        return sharding._map(
            lambda x, sh: x if sh is None else sharding.distribute(x, sh),
            tree, shardings)


def _writer() -> bool:
    """Whether this process writes the files: rank 0 of a process group,
    or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _host_flat(tree) -> dict:
    """Every leaf by path, copied to host memory now."""
    return {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}
