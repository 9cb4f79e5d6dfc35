"""Request-lifecycle scheduler for continuous batching.

State machine (one :class:`ScheduledRequest` per admitted request):

    WAITING --admit--> PREFILL --pack+join--> DECODE --stop/length--> DONE
       ^                  |                      |
       '----- preempt (free blocks, requeue) ----'

(Under chunked prefill the PREFILL state spans several scheduler rounds —
``pf_written`` tracks how much of the prompt has landed in the pool; the
PREFILL->DECODE edge fires when the final chunk samples the first token
inside a mixed segment instead of at a blocking per-request prefill.)

* **FCFS within a priority class** — arrivals queue in order; the best
  queued request (highest :attr:`Request.priority`, then earliest
  deadline, then submit order) is admitted as soon as (a) a batch row is
  free and (b) the pool can commit its admission need.  A blocked head
  blocks the queue (no skipping to a lower class: backpressure never
  starves the request it is protecting).  With every request at the
  default priority and no deadlines this is exactly FCFS.
* **Prefix caching** (``prefix_cache=True``, preemptive mode only) —
  admission hashes the prompt's full blocks (:func:`~repro_torch.serve.kv_pool.
  prefix_keys`), maps the longest registered chain into the new table at
  refcount+1 (reviving cached-free blocks), and commits pool headroom
  only for the unique suffix.  At most ``prompt_len - 1`` tokens are
  shared — the suffix prefill must produce the last prompt position's
  logits to sample the first token.  When the cached chain covers the
  whole prompt the final shared block is taken copy-on-write
  (``ScheduledRequest.cow_src``): the engine duplicates the page, the
  table points at the copy, and the source loses the extra reference —
  the suffix prefill then recomputes the tail block's logits with its
  page writes masked (the copied bytes are already exact), never
  touching the other owners' pages.
* **Preemptive admission** (``preemptive=True``, the continuous engine's
  default) — admission commits only the request's *actual* prompt blocks,
  not its worst case.  Decode growth (:meth:`ensure_capacity`) can
  therefore fail mid-flight; when it does, the engine preempts a victim —
  **lowest-priority-newest first**: the cheapest class pays for pool
  pressure, and within a class the oldest admission is never evicted by
  a younger one and always runs to completion (FCFS-fair, guaranteed
  progress: after evicting every younger request the oldest's worst case
  fits by the :meth:`submit`-time capacity check).  :meth:`preempt` frees
  the victim's blocks and requeues it ahead of every never-admitted
  arrival; re-admission *recomputes* its pool state by prefilling the
  original prompt plus every token generated so far
  (``ScheduledRequest.cur_prompt``), which the request-id-folded sampler
  RNG makes token-identical to an uninterrupted run.
* **Reservation mode** (``preemptive=False``, the legacy contract kept as
  the overload-benchmark baseline) — admission reserves the worst case
  ``blocks_for(prompt_len + max_new)`` up front (counted in
  ``outstanding``) and backpressures the head when the pool cannot commit
  it; growth then draws on the reservation and can never fail, and nothing
  is ever evicted.
* **Bounded queue / load shedding** (``max_queue=``) — at most ``max_queue``
  requests may sit between arrival and admission (preempted requeues
  included).  :meth:`poll_arrivals` tail-drops arrivals past the bound
  (the engine retires them as ``SHED``); a preemption requeue into a full
  queue evicts the newest queued arrival, and when the queue holds only
  preempted peers the victim itself is dropped (retired as ``PREEMPTED``
  with its partial output) — overload degrades by shedding work, never by
  corrupting it.
* **No leaks** — :meth:`finish` returns every allocated block (and, in
  reservation mode, the unallocated remainder of the reservation); after
  all requests retire the allocator is exactly full again, and with
  ``debug=True`` every ``finish`` re-proves
  :meth:`~repro_torch.serve.kv_pool.BlockAllocator.check_invariants`.

The scheduler is pure host bookkeeping: it never touches device arrays.
The driver (serve/server.py) owns pages and block tables and asks the
scheduler what to admit, grow, preempt, and retire between decode segments;
it surfaces each request's outcome as a :class:`RequestStatus`.
"""
from __future__ import annotations

import collections
import dataclasses
import enum

import numpy as np

from repro_torch.serve.kv_pool import BlockAllocator, blocks_for, prefix_keys

# Priority classes (Request.priority is an open int scale — higher wins;
# these two names cover the common split).
PRIORITY_BATCH = 0
PRIORITY_INTERACTIVE = 1


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


class RequestStatus(enum.Enum):
    """Terminal outcome of a request, surfaced on RequestResult.status.

    OK        — ran to completion (finish_reason 'stop' or 'length'); a
                request preempted and recomputed along the way still ends
                OK with a token stream bit-identical to an undisturbed run
                (n_preemptions records the evictions).
    PREEMPTED — evicted under overload and dropped because the bounded
                queue held only preempted peers; partial tokens returned.
    TIMEOUT   — deadline_steps elapsed (arrival -> now) before completion;
                partial tokens returned, blocks released between segments.
    CANCELLED — client cancel() honored at a segment boundary; partial
                tokens returned.
    SHED      — bounded arrival queue was full; never admitted, no tokens.
    FAILED    — non-finite logits quarantined the row mid-decode; tokens up
                to the last finite step returned, batch peers unaffected.
    """
    OK = "ok"
    PREEMPTED = "preempted"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    SHED = "shed"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    """One generation request as submitted by the client."""
    rid: int
    prompt: np.ndarray            # [S] int32 token ids
    max_new: int
    arrival_step: int = 0         # sim time (decode steps) when it arrives
    stop_tokens: tuple[int, ...] = ()
    deadline_steps: int | None = None   # retire as TIMEOUT after this many
    #                                     sim steps past arrival (None: never)
    priority: int = PRIORITY_BATCH      # higher = admitted first / evicted
    #                                     last (PRIORITY_INTERACTIVE > batch)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt_len < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError(
                f"request {self.rid}: deadline_steps must be >= 1")
        self.priority = int(self.priority)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class ScheduledRequest:
    """Scheduler-side record: lifecycle state + block ownership + progress."""
    req: Request
    state: State
    row: int                      # batch row while PREFILL/DECODE, else -1
    blocks: list[int]             # allocated pool blocks (in table order)
    total_blocks: int             # worst-case blocks (growth cap; reserved
    #                               up front only in reservation mode)
    ctx_len: int = 0              # cache positions written (prompt + decoded)
    n_out: int = 0                # tokens emitted
    pf_written: int = 0           # chunked prefill: prompt tokens in the pool
    admitted_step: int = -1       # first admission (re-admissions keep it)
    first_token_step: int = -1
    finished_step: int = -1
    admit_seq: int = -1           # monotonic admission stamp (victim order)
    n_preempt: int = 0            # times evicted (re-admission recomputes)
    resume_prompt: np.ndarray | None = None   # prompt + generated-so-far
    spilled: bool = False         # page-out: KV lives in the host SpillStore
    spill_blocks: int = 0         # blocks the spilled KV needs at re-admission
    shared_tokens: int = 0        # prompt tokens served from cached prefix
    #                               blocks at the last admission (cache hit)
    pf_start: int = 0             # block-aligned prefill start: positions
    #                               [0, pf_start) are already in the pool via
    #                               shared blocks; prefill covers the rest
    cow_src: int = -1             # pending copy-on-write: the engine must
    #                               copy this page into the table's last
    #                               shared slot before any prefill dispatch
    cow_skip: bool = False        # chunked exact-hit: the next chunk spans
    #                               only the CoW-copied (byte-exact) block,
    #                               so its page writes are masked

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def cur_prompt(self) -> np.ndarray:
        """The prompt a (re-)admission prefills: the original prompt, plus —
        after a preemption — every token generated before the eviction
        (recompute-on-readmit rebuilds the pool state from tokens)."""
        return (self.req.prompt if self.resume_prompt is None
                else self.resume_prompt)

    @property
    def cur_prompt_len(self) -> int:
        return int(self.cur_prompt.shape[0])


class Scheduler:
    def __init__(self, allocator: BlockAllocator, max_batch: int,
                 block_size: int, *, preemptive: bool = False,
                 prefix_cache: bool = False,
                 max_queue: int | None = None, debug: bool = False,
                 metrics=None):
        if prefix_cache and not preemptive:
            raise ValueError("prefix_cache requires preemptive scheduling "
                             "(reservation-mode worst-case accounting "
                             "cannot express shared blocks)")
        self.allocator = allocator
        self.max_batch = max_batch
        self.block_size = block_size
        self.preemptive = preemptive
        self.prefix_cache = prefix_cache
        self.max_queue = max_queue
        self.debug = debug
        # Optional telemetry.MetricsRegistry: the scheduler reports its own
        # decisions (submissions, admissions, queue depth) and stays fully
        # functional without one (standalone/unit use).
        self.metrics = metrics
        self.pending: collections.deque[Request] = collections.deque()
        self.arrived: collections.deque[Request] = collections.deque()
        self.preempted: list[ScheduledRequest] = []   # FCFS by submit order
        self.running: dict[int, ScheduledRequest] = {}   # row -> record
        self.finished: list[ScheduledRequest] = []
        self._free_rows = list(range(max_batch - 1, -1, -1))
        self.outstanding = 0      # reservation mode: reserved-not-allocated
        self._last_arrival = None
        self._submit_seq: dict[int, int] = {}         # rid -> FCFS rank
        self._admit_seq = 0

    # ----------------------------------------------------------- submission

    def total_blocks_for(self, req: Request) -> int:
        return blocks_for(req.prompt_len + req.max_new, self.block_size)

    def submit(self, req: Request) -> None:
        total = self.total_blocks_for(req)
        if total > self.allocator.capacity:
            raise ValueError(
                f"request {req.rid} needs {total} blocks "
                f"(prompt {req.prompt_len} + max_new {req.max_new}) but the "
                f"pool holds {self.allocator.capacity}")
        if self._last_arrival is not None \
                and req.arrival_step < self._last_arrival:
            raise ValueError("submit requests in arrival order "
                             f"(request {req.rid} arrives at "
                             f"{req.arrival_step} < {self._last_arrival})")
        self._last_arrival = req.arrival_step
        self._submit_seq[req.rid] = len(self._submit_seq)
        self.pending.append(req)
        if self.metrics is not None:
            self.metrics.counter("serve_submitted_total").inc()

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.arrived or self.preempted
                    or self.running)

    @property
    def queue_len(self) -> int:
        """Requests between arrival and admission (the bounded queue)."""
        return len(self.arrived) + len(self.preempted)

    def next_arrival(self) -> int | None:
        return self.pending[0].arrival_step if self.pending else None

    def poll_arrivals(self, now: int) -> list[Request]:
        """Move arrived requests into the admission queue; returns the
        arrivals tail-dropped by the ``max_queue`` overload bound (the
        engine retires them as SHED)."""
        shed = []
        while self.pending and self.pending[0].arrival_step <= now:
            req = self.pending.popleft()
            if self.max_queue is not None \
                    and self.queue_len >= self.max_queue:
                shed.append(req)
            else:
                self.arrived.append(req)
        return shed

    def remove_queued(self, rid: int):
        """Pull a not-yet-running request out of the queues (cancel /
        timeout).  Returns the Request (never admitted), the
        ScheduledRequest (preempted, holds partial progress), or None."""
        for q in (self.arrived, self.pending):
            for r in q:
                if r.rid == rid:
                    q.remove(r)
                    return r
        for sr in self.preempted:
            if sr.rid == rid:
                self.preempted.remove(sr)
                return sr
        return None

    # ------------------------------------------------------------ admission

    def _class_key(self, r) -> tuple:
        """Admission order within the queues: priority class first (higher
        admitted sooner); within an ELEVATED class, earliest absolute
        deadline (SLO-aware: ``deadline_steps`` composes — an undeadlined
        peer sorts last in its class); submit order breaks ties.  The
        default class (priority 0, every legacy request) stays strict
        FCFS regardless of deadlines."""
        req = r.req if isinstance(r, ScheduledRequest) else r
        dl = (req.arrival_step + req.deadline_steps
              if req.priority > 0 and req.deadline_steps is not None
              else float("inf"))
        return (-req.priority, dl, self._submit_seq[req.rid])

    def _prefix_plan(self, prompt) -> tuple[list[int], int, bool]:
        """(matched blocks, shareable tokens, cow) for admitting `prompt`.

        Shareable tokens are capped at ``prompt_len - 1``: the suffix
        prefill must recompute at least the final prompt position to
        produce the logits the first sampled token comes from.  ``cow``
        is True when the cached chain covers the WHOLE prompt — the last
        matched block then still carries that final position, so it is
        mapped copy-on-write rather than referenced in place."""
        if not self.prefix_cache:
            return [], 0, False
        s = int(len(prompt))
        matched = self.allocator.match_prefix(
            prefix_keys(prompt, self.block_size))
        t_s = min(len(matched) * self.block_size, s - 1)
        n_sh = blocks_for(t_s, self.block_size)
        return matched[:n_sh], t_s, n_sh * self.block_size > t_s

    def _acquire_for_prompt(self, prompt,
                            n_total: int) -> tuple | None:
        """Commit `n_total` table blocks for `prompt`: the longest cached
        prefix chain at refcount+1 (cached-free matches revived) plus
        fresh blocks for the unique suffix.  All-or-nothing — returns
        ``(blocks, shared_tokens, cow_src)`` or None (backpressure, books
        untouched)."""
        matched, t_s, cow = self._prefix_plan(prompt)
        fresh = n_total - len(matched) + (1 if cow else 0)
        n_revive = sum(1 for b in matched
                       if self.allocator.refcount(b) == 0)
        if self.allocator.free_blocks - n_revive < fresh:
            return None
        self.allocator.acquire_cached(matched)
        got = self.allocator.alloc(fresh)
        assert got is not None             # headroom just checked
        if cow:
            # Exact-full-prompt hit: swap the fresh block into the last
            # shared slot and drop our reference on the source — the
            # engine's page copy is dispatched before any later prefill
            # could reuse the source page, so decref-now is safe.
            src = matched[-1]
            blocks = matched[:-1] + [got[0]] + got[1:]
            self.allocator.free([src])
            return blocks, t_s, src
        return matched + got, t_s, -1

    def admit_ready(self, now: int) -> list[ScheduledRequest]:
        """Admit while a batch row is free and the pool can commit the
        best queued request's admission need: preempted requeues first
        (they hold progress — and arrived before anything still waiting),
        then arrivals; both ordered by :meth:`_class_key`.

        Preemptive mode commits the *actual* current-prompt blocks (minus
        whatever a cached prefix supplies — see :meth:`_acquire_for_prompt`);
        the reservation baseline commits the worst case and books the
        growth remainder in ``outstanding``.  Returns the records in
        PREFILL state (a re-admitted record has ``n_preempt > 0`` and
        resumes from ``cur_prompt`` / ``n_out``; a cache-hit record has
        ``shared_tokens > 0`` and prefills from ``pf_start``)."""
        admitted = []
        while self._free_rows:
            if self.preempted:
                sr = self.preempted[0]
                if sr.spilled:
                    # A spilled record re-admits onto exactly the blocks
                    # its host-side KV needs (scatter, no recompute) —
                    # always exclusive pages, sharing would alias the
                    # incoming bytes.
                    got = None
                    if self.allocator.free_blocks >= sr.spill_blocks:
                        got = self.allocator.alloc(sr.spill_blocks)
                    if got is None:
                        break              # backpressure: head waits
                    sr.blocks = got
                    sr.shared_tokens, sr.pf_start, sr.cow_src = 0, 0, -1
                else:
                    # Recompute path: the re-prefill rebuilds ctx from
                    # the grown prompt — and can itself ride cached
                    # prefix blocks (including its own, freed at
                    # preemption and still registered).
                    res = self._acquire_for_prompt(
                        sr.cur_prompt,
                        blocks_for(sr.cur_prompt_len, self.block_size))
                    if res is None:
                        break              # backpressure: head waits
                    sr.blocks, sr.shared_tokens, sr.cow_src = res
                    sr.pf_start = (sr.shared_tokens // self.block_size
                                   ) * self.block_size
                    sr.ctx_len = sr.cur_prompt_len
                    sr.pf_written = 0
                self.preempted.pop(0)
                sr.state = State.PREFILL
                sr.row = self._free_rows.pop()
                sr.admit_seq = self._admit_seq
                self._admit_seq += 1
                self.running[sr.row] = sr
                admitted.append(sr)
                continue
            if not self.arrived:
                break
            idx = min(range(len(self.arrived)),
                      key=lambda i: self._class_key(self.arrived[i]))
            req = self.arrived[idx]
            total = self.total_blocks_for(req)
            init = blocks_for(req.prompt_len, self.block_size)
            if self.preemptive:
                res = self._acquire_for_prompt(req.prompt, init)
                if res is None:
                    break                  # backpressure: head waits
                blocks, t_s, cow_src = res
            else:
                if self.allocator.free_blocks - self.outstanding < total:
                    break                  # backpressure: head waits
                blocks = self.allocator.alloc(init)
                assert blocks is not None  # free - outstanding >= total
                t_s, cow_src = 0, -1
            sr = ScheduledRequest(
                req=req, state=State.PREFILL, row=self._free_rows.pop(),
                blocks=blocks, total_blocks=total, ctx_len=req.prompt_len,
                admitted_step=now, admit_seq=self._admit_seq,
                shared_tokens=t_s,
                pf_start=(t_s // self.block_size) * self.block_size,
                cow_src=cow_src)
            self._admit_seq += 1
            if not self.preemptive:
                self.outstanding += total - init
            self.running[sr.row] = sr
            del self.arrived[idx]
            admitted.append(sr)
        if self.metrics is not None:
            if admitted:
                self.metrics.counter("serve_admissions_total").inc(
                    len(admitted))
            self.metrics.gauge("serve_queue_depth").set(self.queue_len)
        return admitted

    def ensure_capacity(self, sr: ScheduledRequest,
                        target_len: int) -> list[int] | None:
        """Grow sr's allocation to cover `target_len` cache positions
        (capped at its worst case).  Returns the new blocks to append to
        the request's block table ([] when already covered).

        Reservation mode draws on blocks reserved at admission and can
        never fail (asserted).  Preemptive mode returns None when the pool
        cannot supply the growth — the engine's cue to preempt a victim and
        retry."""
        want = min(blocks_for(target_len, self.block_size), sr.total_blocks)
        need = want - len(sr.blocks)
        if need <= 0:
            return []
        got = self.allocator.alloc(need)
        if got is None:
            if not self.preemptive:
                raise AssertionError(
                    "admission reservation violated: pool exhausted "
                    "mid-decode")
            return None
        sr.blocks.extend(got)
        if not self.preemptive:
            self.outstanding -= need
        return got

    # ------------------------------------------------------------ preempt

    def pick_victim(self,
                    exclude_rid: int | None = None) -> ScheduledRequest | None:
        """The lowest-priority-newest running request: the cheapest class
        pays for pool pressure first, and within a class the newest
        admission is evicted (FCFS-fair — the oldest admission is never
        evicted by a younger peer, so the head of the line always makes
        progress)."""
        cands = [sr for sr in self.running.values()
                 if sr.rid != exclude_rid]
        if not cands:
            return None
        return max(cands, key=lambda s: (-s.req.priority, s.admit_seq))

    def preempt(self, sr: ScheduledRequest, now: int, *,
                spill_blocks: int | None = None
                ) -> tuple[bool, Request | None]:
        """Evict a running request: free its blocks, release its row, and
        requeue it.  With ``spill_blocks=None`` the re-admission recomputes
        from ``resume_prompt`` (the caller stashes it first); with
        ``spill_blocks=n`` the record is marked *spilled* — its KV bytes
        live in the engine's host SpillStore and re-admission allocates
        exactly ``n`` blocks to scatter them back into, no recompute.
        Returns ``(requeued, evicted)``:

        * queue has room -> ``(True, None)``;
        * queue full but holds a never-admitted arrival -> the newest such
          arrival is evicted to make room, ``(True, evicted_request)`` (the
          engine sheds it);
        * queue full of preempted peers -> ``(False, None)``: the victim is
          dropped (the engine retires it as PREEMPTED with partial output).
        """
        if not self.preemptive:
            raise RuntimeError("preempt() requires preemptive scheduling")
        self.allocator.free(sr.blocks)
        sr.blocks = []
        del self.running[sr.row]
        self._free_rows.append(sr.row)
        sr.row = -1
        sr.state = State.WAITING
        sr.pf_written = 0
        sr.n_preempt += 1
        sr.shared_tokens = 0
        sr.pf_start = 0
        sr.cow_src = -1
        sr.cow_skip = False
        if spill_blocks is not None:
            sr.spilled = True
            sr.spill_blocks = spill_blocks
        else:
            sr.spilled = False
            sr.spill_blocks = 0
        evicted = None
        if self.max_queue is not None and self.queue_len >= self.max_queue:
            if self.arrived:
                evicted = self.arrived.pop()   # newest arrival sheds
            else:
                return False, None             # only preempted peers queued
        self.preempted.append(sr)
        self.preempted.sort(key=self._class_key)
        return True, evicted

    # -------------------------------------------------------------- retire

    def finish(self, sr: ScheduledRequest, now: int) -> None:
        """Retire a record (DONE): free all blocks, release the batch row
        (when it holds one), and — in reservation mode — return the
        unallocated remainder of the reservation.  Works for running AND
        preempted records (cancel/timeout can retire either)."""
        self.allocator.free(sr.blocks)
        if not self.preemptive:
            self.outstanding -= sr.total_blocks - len(sr.blocks)
        sr.blocks = []
        if sr.row >= 0:
            del self.running[sr.row]
            self._free_rows.append(sr.row)
            sr.row = -1
        elif sr in self.preempted:
            self.preempted.remove(sr)
        sr.state = State.DONE
        sr.finished_step = now
        self.finished.append(sr)
        if self.debug:
            self.allocator.check_invariants(
                tables=[r.blocks for r in self.running.values()],
                spilled=[(r.rid, r.blocks) for r in self.preempted
                         if r.spilled])

    # ------------------------------------------------------ state round-trip

    def to_state(self) -> dict:
        """Plain-python snapshot of every queue and record (prompts/tokens
        are serialized by the engine's snapshot layer; records reference
        requests by rid).  Paired with :meth:`load_state`."""
        def rec(sr: ScheduledRequest) -> dict:
            return {"rid": sr.rid, "state": sr.state.value, "row": sr.row,
                    "blocks": [int(b) for b in sr.blocks],
                    "total_blocks": sr.total_blocks, "ctx_len": sr.ctx_len,
                    "n_out": sr.n_out, "pf_written": sr.pf_written,
                    "admitted_step": sr.admitted_step,
                    "first_token_step": sr.first_token_step,
                    "admit_seq": sr.admit_seq, "n_preempt": sr.n_preempt,
                    "spilled": sr.spilled, "spill_blocks": sr.spill_blocks,
                    "shared_tokens": sr.shared_tokens,
                    "pf_start": sr.pf_start, "cow_src": sr.cow_src,
                    "cow_skip": sr.cow_skip,
                    "has_resume": sr.resume_prompt is not None}
        return {"pending": [r.rid for r in self.pending],
                "arrived": [r.rid for r in self.arrived],
                "preempted": [rec(sr) for sr in self.preempted],
                "running": [rec(sr) for sr in self.running.values()],
                "free_rows": list(self._free_rows),
                "outstanding": self.outstanding,
                "last_arrival": self._last_arrival,
                "submit_seq": [[int(r), int(s)]
                               for r, s in self._submit_seq.items()],
                "admit_seq": self._admit_seq}

    def load_state(self, state: dict, requests: dict,
                   resume_prompts: dict | None = None) -> None:
        """Repopulate a freshly constructed scheduler from :meth:`to_state`.
        ``requests`` maps rid -> Request for every rid the state references;
        ``resume_prompts`` maps rid -> token array for records whose
        re-admission recomputes (``has_resume``)."""
        resume_prompts = resume_prompts or {}

        def rec(d: dict) -> ScheduledRequest:
            sr = ScheduledRequest(
                req=requests[d["rid"]], state=State(d["state"]),
                row=int(d["row"]),
                blocks=[int(b) for b in d["blocks"]],
                total_blocks=int(d["total_blocks"]),
                ctx_len=int(d["ctx_len"]), n_out=int(d["n_out"]),
                pf_written=int(d["pf_written"]),
                admitted_step=int(d["admitted_step"]),
                first_token_step=int(d["first_token_step"]),
                admit_seq=int(d["admit_seq"]),
                n_preempt=int(d["n_preempt"]), spilled=bool(d["spilled"]),
                spill_blocks=int(d["spill_blocks"]),
                shared_tokens=int(d.get("shared_tokens", 0)),
                pf_start=int(d.get("pf_start", 0)),
                cow_src=int(d.get("cow_src", -1)),
                cow_skip=bool(d.get("cow_skip", False)))
            if d["has_resume"]:
                sr.resume_prompt = np.asarray(
                    resume_prompts[d["rid"]], np.int32)
            return sr

        self.pending = collections.deque(
            requests[rid] for rid in state["pending"])
        self.arrived = collections.deque(
            requests[rid] for rid in state["arrived"])
        self.preempted = [rec(d) for d in state["preempted"]]
        self.running = {}
        for d in state["running"]:
            sr = rec(d)
            self.running[sr.row] = sr
        self._free_rows = [int(r) for r in state["free_rows"]]
        self.outstanding = int(state["outstanding"])
        last = state["last_arrival"]
        self._last_arrival = None if last is None else int(last)
        self._submit_seq = {int(r): int(s) for r, s in state["submit_seq"]}
        self._admit_seq = int(state["admit_seq"])
        if self.debug:
            self.allocator.check_invariants(
                tables=[r.blocks for r in self.running.values()],
                spilled=[(r.rid, r.blocks) for r in self.preempted
                         if r.spilled])
