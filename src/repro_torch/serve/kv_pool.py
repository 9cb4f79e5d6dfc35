"""Paged KV-cache pool for continuous-batching serve (port of
``repro/serve/kv_pool.py``: pages, defrag and the host allocator).

* **Device pages** -- ``{"k": pages, "v": pages}`` with layout
  ``[L, num_blocks, block_size, KVH, HD]``.  An int8 pool
  (``cfg.kv_cache_dtype == "int8"``) stores each half as a
  :class:`~repro_torch.core.quant.QTensor`: int8 codes plus a bf16
  per-token-head scale ``[L, num_blocks, block_size, KVH, 1]``.  The
  kernels and the model update pages in place.
* **Host allocator** -- :class:`BlockAllocator` (numpy-only, identical to
  the JAX package's), a refcounted free-list over block ids.  Block 0 is
  the reserved **null block**: masked writes and the padding tail of every
  block table point there, so device shapes stay static.

Host spill, block copy/extract/insert and snapshots arrive with the
durability slice.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import quant

NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `n_tokens` cache positions."""
    return -(-n_tokens // block_size)


# ---------------------------------------------------------------------------
# Prefix keys (content addressing)
# ---------------------------------------------------------------------------

def hash_block_tokens(parent_key: str | None, tokens) -> str:
    """Chain key for one FULL block of prompt tokens: sha256 over the
    parent block's key plus this block's token ids.  Chaining makes the
    key cover the whole prefix up to and including the block, so equal
    keys imply equal *prefixes* (not just equal block contents), which is
    the property that lets admission map someone else's pages into a new
    block table.  sha256 (not ``hash()``) so keys are stable across
    processes / PYTHONHASHSEED — they ride snapshots."""
    h = hashlib.sha256()
    h.update(b"\x00" if parent_key is None else parent_key.encode("ascii"))
    h.update(np.ascontiguousarray(
        np.asarray(tokens, dtype=np.int64)).tobytes())
    return h.hexdigest()


def prefix_keys(tokens, block_size: int) -> list[str]:
    """Chain keys for every FULL block of `tokens` (the partial tail block,
    if any, has no key — only completely-written blocks are shareable)."""
    toks = np.asarray(tokens, dtype=np.int64)
    keys: list[str] = []
    parent: str | None = None
    for i in range(len(toks) // block_size):
        parent = hash_block_tokens(
            parent, toks[i * block_size:(i + 1) * block_size])
        keys.append(parent)
    return keys


# ---------------------------------------------------------------------------
# Device pages
# ---------------------------------------------------------------------------

def init_pages(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
               *, device="cuda"):
    """Zero page pool shaped for `cfg`'s stack: {'k','v'} with leaves
    [L, num_blocks, block_size, KVH, HD]; int8 pools store QTensors whose
    scale leaf is [L, num_blocks, block_size, KVH, 1]."""
    dev = device_lib.resolve(device)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, hd)
    int8 = (getattr(cfg, "kv_cache_dtype", "bf16") == "int8"
            and cfg.sliding_window is None)
    if int8:
        def qt():
            return quant.QTensor(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros((*shape[:-1], 1), dtype=torch.bfloat16,
                            device=dev))
        return {"k": qt(), "v": qt()}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def pages_block_size(pages) -> int:
    k = pages["k"]
    return (k.q if isinstance(k, quant.QTensor) else k).shape[2]


def pages_num_blocks(pages) -> int:
    k = pages["k"]
    return (k.q if isinstance(k, quant.QTensor) else k).shape[1]


def apply_defrag(pages, block_tables, remap: dict[int, int]):
    """Apply a :meth:`BlockAllocator.defrag` remap: permute the pool's
    block axis and rewrite every block table.  Returns (pages,
    block_tables); tables are taken and returned as host numpy int32."""
    nb = pages_num_blocks(pages)
    perm = np.arange(nb)
    lut = np.arange(nb)
    for old, new in remap.items():
        perm[new] = old
        lut[old] = new

    def permute(p):
        if isinstance(p, quant.QTensor):
            return quant.QTensor(permute(p.q), permute(p.scale))
        return p[:, torch.as_tensor(perm, device=p.device)]

    pages = {name: permute(p) for name, p in pages.items()}
    return pages, lut[np.asarray(block_tables)].astype(np.int32)


# ---------------------------------------------------------------------------
# Host allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted, content-addressable free-list allocator over the pool's
    blocks (block 0 reserved null).

    Capacity accounting is exact: every block is free, live, or the null
    block, and `alloc` is all-or-nothing (returns None when the request
    cannot be satisfied — the scheduler's admission backpressure signal).

    Sharing (vLLM-style prefix caching) layers on top without changing
    that partition: a live block carries a refcount (>= 1), and
    :meth:`free` is a decref — the page only returns to the free list at
    refcount 0.  Fully-written prompt blocks can be *registered* under a
    chained content key (:func:`prefix_keys`); a registered block stays
    matchable even after its last owner retires ("cached-free": on the
    free list, bytes intact, key still indexed) until :meth:`alloc` hands
    it out again or :meth:`hide_blocks`/:meth:`defrag` invalidates it.
    Admission revives cached-free matches via :meth:`acquire_cached`
    (refcount 1) or increfs live matches — either way the new request's
    table points at pages someone else wrote, and prefill runs only on
    the unique suffix."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: collections.deque[int] = collections.deque(
            range(1, num_blocks))
        self._live: set[int] = set()
        self._hidden: list[int] = []
        # Sharing books: refcounts for live blocks, and the two-way
        # content index (block -> chain key, chain key -> block) covering
        # live-registered plus cached-free blocks.
        self._ref: dict[int, int] = {}
        self._block_hash: dict[int, str] = {}
        self._hash_index: dict[str, int] = {}

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._live)

    @property
    def hidden_blocks(self) -> int:
        return len(self._hidden)

    def occupancy(self) -> float:
        return len(self._live) / self.capacity

    @property
    def fragmented(self) -> bool:
        """True when live blocks are not a contiguous prefix (a defrag
        would move something)."""
        return bool(self._live) and max(self._live) > len(self._live)

    @property
    def hole_blocks(self) -> int:
        """Free slots inside the live span: max(live) - #live (0 when
        contiguous or empty)."""
        if not self._live:
            return 0
        return max(self._live) - len(self._live)

    def fragmentation(self) -> float:
        """Hole fraction of the live span: (max(live) - #live) / max(live).

        0.0 when the live blocks are a contiguous prefix (or the pool is
        empty); approaches 1.0 as live blocks scatter across a mostly-free
        span.  The continuous engine defrags adaptively when this crosses
        its threshold (and the absolute hole count is worth a pool
        permutation), keeping block tables contiguous for the fused
        kernel's sequential page walks."""
        if not self._live:
            return 0.0
        return self.hole_blocks / max(self._live)

    @property
    def shared_blocks(self) -> int:
        """Live blocks referenced by more than one block table."""
        return sum(1 for c in self._ref.values() if c > 1)

    @property
    def owned_blocks(self) -> int:
        """Live blocks exclusively owned (refcount exactly 1)."""
        return sum(1 for c in self._ref.values() if c == 1)

    @property
    def cached_blocks(self) -> int:
        """Free blocks still registered in the prefix index (bytes intact,
        revivable by a matching admission until reallocated)."""
        return sum(1 for b in self._block_hash if b not in self._live)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts == block-table entries backed by the pool.
        ``total_refs - live_blocks`` is the capacity sharing saves."""
        return sum(self._ref.values())

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_shared(self, block: int) -> bool:
        return self._ref.get(block, 0) > 1

    def stats(self) -> dict:
        """One-call pool health snapshot (the engine samples this once per
        scheduler round for its gauges / trace counters).  `live` counts
        physical blocks; `shared`/`owned` split it by refcount (>1 vs ==1)
        and `refs` is the table-entry view — `refs - live` blocks of
        capacity exist only because of sharing.  `cached` counts free
        blocks still matchable through the prefix index."""
        return {"capacity": self.capacity,
                "free": self.free_blocks,
                "live": self.live_blocks,
                "hidden": self.hidden_blocks,
                "holes": self.hole_blocks,
                "shared": self.shared_blocks,
                "owned": self.owned_blocks,
                "cached": self.cached_blocks,
                "refs": self.total_refs,
                "occupancy": self.occupancy(),
                "fragmentation": self.fragmentation()}

    def _forget(self, block: int) -> None:
        """Drop `block`'s prefix-index entry (its bytes are about to be
        reused / moved / hidden, so the key must stop matching)."""
        key = self._block_hash.pop(block, None)
        if key is not None:
            self._hash_index.pop(key, None)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks at refcount 1, or None (all-or-nothing) when fewer
        than n are free.  Handing out a cached-free block invalidates its
        prefix-index entry — its bytes now belong to the new owner."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.popleft() for _ in range(n)]
        for b in blocks:
            self._forget(b)
            self._ref[b] = 1
        self._live.update(blocks)
        return blocks

    def free(self, blocks) -> None:
        """Decref each block; a page returns to the free list only at
        refcount 0.  Registered blocks keep their prefix-index entry
        while free ("cached-free") so later admissions can revive them."""
        for b in blocks:
            if b not in self._live:
                raise ValueError(f"double free / unknown block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._live.discard(b)
                self._free.append(b)

    def incref(self, block: int) -> None:
        """Add one table's reference to a live block (prefix sharing)."""
        if block not in self._live:
            raise ValueError(f"incref on non-live block {block}")
        self._ref[block] += 1

    def register_prefix(self, block: int, key: str) -> bool:
        """Index a fully-written live block under its chain `key`.  No-op
        (False) when the key is already indexed — first writer wins, and
        later identical prefixes share the canonical block instead of
        registering duplicates."""
        if block not in self._live:
            raise ValueError(f"register_prefix on non-live block {block}")
        if key in self._hash_index:
            return False
        if block in self._block_hash:  # re-register under a new key
            self._forget(block)
        self._block_hash[block] = key
        self._hash_index[key] = block
        return True

    def match_prefix(self, keys: list[str]) -> list[int]:
        """Longest indexed chain: block ids for keys[0..k] such that every
        key is registered (live or cached-free — hidden and reallocated
        blocks were already forgotten).  Chain keys make a match at depth
        i imply matches at all shallower depths, so the walk stops at the
        first miss."""
        blocks: list[int] = []
        for key in keys:
            b = self._hash_index.get(key)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def acquire_cached(self, blocks) -> None:
        """Take one reference on each matched block: incref live blocks,
        revive cached-free ones (off the free list at refcount 1, index
        entry kept).  All-or-nothing is the CALLER's job — the scheduler
        checks suffix headroom before acquiring; roll back a failed
        admission with :meth:`free` (exact inverse)."""
        for b in blocks:
            if b in self._live:
                self._ref[b] += 1
            elif b in self._block_hash:
                self._free.remove(b)
                self._live.add(b)
                self._ref[b] = 1
            else:
                raise ValueError(f"acquire_cached on unregistered block {b}")

    def drop_cached(self) -> int:
        """Invalidate every cached-free prefix entry (chaos action /
        cache-flush): matchable history is lost, bytes and live sharing
        are untouched.  Returns how many entries were dropped."""
        stale = [b for b in self._block_hash if b not in self._live]
        for b in stale:
            self._forget(b)
        return len(stale)

    def hide_blocks(self, n: int) -> int:
        """Fault injection: withdraw up to `n` FREE blocks from circulation
        (popped from the free tail, so the id order handed to subsequent
        allocs is unchanged).  Hidden blocks count as neither free nor
        live — they simulate pool pressure (a co-tenant, a leak under
        test) and force admission backpressure / growth-failure
        preemptions.  A hidden cached-free block is forgotten (a
        co-tenant's pages are not ours to match).  Returns how many were
        actually hidden."""
        n = min(n, len(self._free))
        for _ in range(n):
            b = self._free.pop()
            self._forget(b)
            self._hidden.append(b)
        return n

    def unhide_all(self) -> int:
        """Return every hidden block to the free list (fault cleanup; the
        engine calls this before its end-of-run accounting so a faulted
        run still ends with the allocator exactly full)."""
        n = len(self._hidden)
        self._free.extend(self._hidden)
        self._hidden = []
        return n

    def to_state(self) -> dict:
        """Plain-python snapshot of the books (free-list ORDER included —
        restore must hand out the same block ids in the same order for
        bit-replayable admission; refcounts and the prefix index ride
        along so shared pages stay shared across a restore)."""
        return {"num_blocks": self.num_blocks,
                "free": [int(b) for b in self._free],
                "live": sorted(int(b) for b in self._live),
                "hidden": [int(b) for b in self._hidden],
                "refs": {str(b): int(c) for b, c in self._ref.items()},
                "hashes": {str(b): k for b, k in self._block_hash.items()}}

    @classmethod
    def from_state(cls, state: dict) -> "BlockAllocator":
        """Rebuild an allocator from :meth:`to_state`; the books are
        re-proven before anything trusts them.  Pre-refcount states (no
        "refs"/"hashes") load as all-exclusive with an empty index."""
        alloc = cls(int(state["num_blocks"]))
        alloc._free = collections.deque(int(b) for b in state["free"])
        alloc._live = {int(b) for b in state["live"]}
        alloc._hidden = [int(b) for b in state["hidden"]]
        alloc._ref = {int(b): int(c)
                      for b, c in state.get("refs", {}).items()}
        if not alloc._ref:
            alloc._ref = {b: 1 for b in alloc._live}
        alloc._block_hash = {int(b): str(k)
                             for b, k in state.get("hashes", {}).items()}
        alloc._hash_index = {k: b for b, k in alloc._block_hash.items()}
        alloc.check_invariants()
        return alloc

    def check_invariants(self, tables=None, spilled=None) -> None:
        """Prove the allocator's books balance; raises RuntimeError on the
        first violation.  Checks: free + live + hidden == capacity with no
        overlap and no out-of-range/null ids (a free-list duplicate is the
        signature of a double-free); the refcount partition — every live
        block has refcount >= 1 and nothing else has one at all; the
        prefix index is two-way consistent and covers only live or
        cached-free blocks; given `tables`, an iterable of block-id
        sequences, that tables reference only live blocks (or the null
        block as padding) and that every referenced block's table
        occurrences EQUAL its refcount (an unshared block in two tables
        is still the classic double-own; a shared block in fewer tables
        than its refcount is a leak); given `spilled`, an iterable of
        (rid, blocks) pairs for paged-out requests, that none of them
        still holds device blocks (spilled KV lives on the host — a
        retained block is a leak)."""
        free = list(self._free)
        if len(set(free)) != len(free):
            raise RuntimeError("allocator: duplicate ids on the free list "
                               "(double free)")
        free_s, hid_s = set(free), set(self._hidden)
        for name, ids in (("free", free_s), ("live", self._live),
                          ("hidden", hid_s)):
            bad = [b for b in ids if not 1 <= b < self.num_blocks]
            if bad:
                raise RuntimeError(
                    f"allocator: {name} ids out of range: {sorted(bad)}")
        for a, b in (("free", "live"), ("free", "hidden"),
                     ("live", "hidden")):
            inter = {"free": free_s, "live": self._live,
                     "hidden": hid_s}[a] & \
                    {"free": free_s, "live": self._live, "hidden": hid_s}[b]
            if inter:
                raise RuntimeError(f"allocator: blocks both {a} and {b}: "
                                   f"{sorted(inter)}")
        total = len(free_s) + len(self._live) + len(hid_s)
        if total != self.capacity:
            raise RuntimeError(
                f"allocator: free({len(free_s)}) + live({len(self._live)}) "
                f"+ hidden({len(hid_s)}) = {total} != capacity "
                f"({self.capacity}) — block leak or phantom block")
        if set(self._ref) != self._live:
            raise RuntimeError(
                f"allocator: refcount keys != live set "
                f"(refs without pages: {sorted(set(self._ref) - self._live)},"
                f" live without refs: {sorted(self._live - set(self._ref))})")
        bad_ref = {b: c for b, c in self._ref.items() if c < 1}
        if bad_ref:
            raise RuntimeError(f"allocator: live blocks with refcount < 1: "
                               f"{bad_ref}")
        if len(self._hash_index) != len(self._block_hash):
            raise RuntimeError("allocator: prefix index out of sync "
                               f"({len(self._hash_index)} keys vs "
                               f"{len(self._block_hash)} blocks)")
        for b, key in self._block_hash.items():
            if self._hash_index.get(key) != b:
                raise RuntimeError(
                    f"allocator: prefix index mismatch for block {b}")
            if b not in self._live and b not in free_s:
                raise RuntimeError(
                    f"allocator: registered block {b} is neither live nor "
                    "free (hidden/out-of-pool bytes must not be matchable)")
        if tables is not None:
            owns = collections.Counter()
            for ti, table in enumerate(tables):
                for b in table:
                    b = int(b)
                    if b == NULL_BLOCK:
                        continue
                    if b not in self._live:
                        raise RuntimeError(
                            f"table {ti} references non-live block {b}")
                    owns[b] += 1
            for b, n in owns.items():
                if n != self._ref[b]:
                    raise RuntimeError(
                        f"block {b} referenced by {n} table entries but "
                        f"refcount is {self._ref[b]} — "
                        + ("double-owned" if n > self._ref[b]
                           else "leaked reference"))
            leaked = {b: c for b, c in self._ref.items() if b not in owns}
            if leaked:
                raise RuntimeError(
                    f"live blocks held by no table: {leaked} (leak)")
        if spilled is not None:
            for rid, blocks in spilled:
                held = [int(b) for b in blocks if int(b) != NULL_BLOCK]
                if held:
                    raise RuntimeError(
                        f"spilled request {rid} still holds device blocks "
                        f"{held}")

    def defrag(self) -> dict[int, int]:
        """Compact live blocks onto the lowest ids; returns {old: new} for
        every moved block (identity moves are omitted).  The caller must
        apply :func:`apply_defrag` to the pages and ALL live block tables
        before the next device step.  Hidden blocks (fault injection) stay
        hidden — they are re-pinned to the compacted free tail.  Refcounts
        and live prefix-index entries follow their blocks; cached-free
        entries are invalidated (the page permutation only preserves live
        bytes — a revived stale id would read someone else's page)."""
        live = sorted(self._live)
        was_live = set(live)
        remap = {old: new for new, old in enumerate(live, start=1)
                 if old != new}
        self._live = set(range(1, len(live) + 1))
        rest = collections.deque(range(len(live) + 1, self.num_blocks))
        self._hidden = [rest.pop() for _ in range(len(self._hidden))]
        self._free = rest
        self._ref = {remap.get(b, b): c for b, c in self._ref.items()}
        self._block_hash = {remap.get(b, b): k
                            for b, k in self._block_hash.items()
                            if b in was_live}
        self._hash_index = {k: b for b, k in self._block_hash.items()}
        return remap
