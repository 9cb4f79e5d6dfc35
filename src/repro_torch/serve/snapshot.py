"""Engine snapshot format: one ``.npz`` holding a serve run at a segment
boundary (the format of ``repro/serve/snapshot.py``, so a file either
package writes restores in the other).

The file is self-describing and weight-free: a JSON ``meta`` record
(version, engine geometry fingerprint, run cursors, scheduler queues,
allocator free-list order, spill-store index), stored as the uint8 bytes
of its text, plus numpy arrays for everything with bytes -- the host row
arrays, the sampler key (``uint32[2]``), every request's prompt, every
in-flight stream, the pool blocks a table or the prefix index can read
(the live ones and the cached-free ones the index still matches, under
the meta key ``live_blocks``; gathered through
:func:`~repro_torch.serve.kv_pool.extract_blocks`, so a mostly empty pool
costs almost nothing), and each spilled request's KV.  ``bfloat16``
leaves travel as their uint16 bit patterns, named in ``meta``'s
``bf16_arrays``; they are read back as uint16 and viewed as bf16 where
they land in the pool, so the round trip is exact to the bit and needs no
bfloat16 dtype in numpy.

Writes are atomic (tmp file + ``os.replace``): a crash mid-snapshot leaves
the previous checkpoint intact, never a torn file.

The module imports only ``kv_pool`` (no engine import): the engine passes
itself duck-typed.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.serve import kv_pool

SNAPSHOT_VERSION = 1

# Array-name prefixes whose uint16 leaves are bf16 bit patterns
# (``extract_blocks``' convention; every other array is int32, float32,
# bool or the uint32 key).
_BF16_SECTIONS = ("pool_", "spill_")


def _geometry(engine) -> dict:
    """The engine-construction fingerprint a restore must match: pool and
    batch geometry plus everything that shapes the serving programs."""
    cfg = engine.cfg
    return {
        "n_layers": int(cfg.n_layers),
        "n_kv_heads": int(cfg.n_kv_heads),
        "head_dim": int(cfg.resolved_head_dim),
        "kv_cache_dtype": getattr(cfg, "kv_cache_dtype", "bf16"),
        "dtype": cfg.dtype,
        "max_batch": engine.max_batch,
        "kv_blocks": engine.allocator.num_blocks,
        "block_size": engine.block_size,
        "max_blocks_per_req": engine.max_blocks_per_req,
        "segment_len": engine.segment_len,
        "chunked_prefill": engine.chunked_prefill,
        "prefill_chunk": engine.prefill_chunk,
        "preemption": engine.preemption,
        "prefix_cache": getattr(engine, "prefix_cache", False),
    }


def check_geometry(engine, saved: dict) -> None:
    """Raise ValueError listing every mismatch between the snapshot's
    geometry fingerprint and this engine's."""
    cur = _geometry(engine)
    diffs = [f"{k}: snapshot {saved.get(k)!r} != engine {cur[k]!r}"
             for k in cur if saved.get(k) != cur[k]]
    if diffs:
        raise ValueError(
            "snapshot/engine geometry mismatch — a warm restart needs an "
            "identically configured engine:\n  " + "\n  ".join(diffs))


def save_snapshot(path, *, engine, state) -> str:
    """Write ``state`` (a server._RunState) + the engine's durable pieces
    (allocator, live pages, spill store) to ``path`` atomically."""
    sched = state.sched
    arrays: dict[str, np.ndarray] = {
        "rng": state.rng.cpu().numpy().astype(np.uint32),
        "tok": state.tok, "n_out": state.n_out, "lens": state.lens,
        "done": state.done, "rids": state.rids, "max_new": state.max_new,
        "stops": state.stops, "tables": state.tables,
    }
    reqs_meta = []
    for rid, req in sorted(state.requests.items()):
        reqs_meta.append({"rid": rid, "max_new": req.max_new,
                          "arrival_step": req.arrival_step,
                          "stop_tokens": [int(t) for t in req.stop_tokens],
                          "deadline_steps": req.deadline_steps,
                          "priority": int(req.priority)})
        arrays[f"prompt_{rid}"] = np.asarray(req.prompt, np.int32)
    for sr in list(sched.running.values()) + list(sched.preempted):
        if sr.resume_prompt is not None:
            arrays[f"resume_{sr.rid}"] = np.asarray(sr.resume_prompt,
                                                    np.int32)
    stream_rids = sorted(state.streams)
    for rid in stream_rids:
        toks, lps = state.streams[rid]
        arrays[f"stream_tok_{rid}"] = np.asarray(toks, np.int32)
        arrays[f"stream_lp_{rid}"] = np.asarray(lps, np.float32)
    # Every block a table or the prefix index can read: the live blocks
    # and the cached-free ones the index still matches.  (The JAX package
    # saves the live blocks only, so its files restore cached-free index
    # entries without their bytes; the port's restore drops those.)
    alloc = engine.allocator
    live = sorted(set(alloc._live) | set(alloc._block_hash))
    if live:
        for k, v in kv_pool.extract_blocks(engine.pages, live).items():
            arrays[f"pool_{k}"] = v
    spill_meta: dict[str, dict] = {}
    for rid in engine.spill.rids():
        e = engine.spill.get(rid)
        spill_meta[str(rid)] = {
            "n_blocks": e.n_blocks, "ctx_len": e.ctx_len,
            "n_out": e.n_out, "pending_tok": e.pending_tok,
            "kv_keys": sorted(e.kv)}
        for k, v in e.kv.items():
            arrays[f"spill_{rid}_{k}"] = v
    bf16_names = []
    for name, a in arrays.items():
        if name.startswith(_BF16_SECTIONS) and a.dtype == np.uint16:
            bf16_names.append(name)
    meta = {
        "version": SNAPSHOT_VERSION,
        "geometry": _geometry(engine),
        "run": {"now": state.now, "n_loops": state.n_loops,
                "greedy": state.greedy, "temperature": state.temperature,
                "stop_w": state.stop_w},
        "scheduler": sched.to_state(),
        "allocator": engine.allocator.to_state(),
        "requests": reqs_meta,
        "streams": stream_rids,
        "spill": spill_meta,
        "live_blocks": live,
        "bf16_arrays": bf16_names,
    }
    path = str(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f,
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 **arrays)
    os.replace(tmp, path)
    return path


def load_snapshot(path) -> tuple[dict, dict[str, np.ndarray]]:
    """Read a snapshot back; returns ``(meta, arrays)``.  The arrays named
    in ``meta["bf16_arrays"]`` stay uint16 bit patterns
    (:func:`~repro_torch.serve.kv_pool.insert_blocks` views them as
    bf16)."""
    with np.load(str(path)) as z:
        arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
        meta = json.loads(bytes(bytearray(z["meta"])).decode())
    if int(meta.get("version", -1)) != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot {path}: version {meta.get('version')!r} != "
            f"supported {SNAPSHOT_VERSION}")
    return meta, arrays
