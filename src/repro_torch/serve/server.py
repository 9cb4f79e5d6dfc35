"""Continuous-batching serve driver over the paged KV pool (port of
``repro/serve/server.py``: blocking and chunked prefill, greedy and seeded
sampling).

``ContinuousEngine.run`` is a synchronous traffic simulator with real
model execution: requests carry an ``arrival_step`` (sim time in decode
steps), join the running batch as soon as the scheduler admits them, and
retire the moment they emit a stop token or reach ``max_new``.

Execution shape:

* **Blocking prefill** (the default) -- one call per admitted request:
  ``model.prefill_paged`` runs the bucketed prompt forward into a dense
  scratch cache, scatters its K/V into the request's pool blocks
  (``kv_pool.pack_prompt``) and samples the first token with the
  request-id-folded key.  An admission round joins with one batched
  device-to-host read of the first tokens.
* **Chunked prefill** (``chunked_prefill=True``) -- admission dispatches
  nothing.  Each PREFILL row
  advances ``prefill_chunk`` prompt tokens per segment inside the same
  segment as the decoding rows: a pow2-bucketed sub-batch of prefilling
  rows runs ``model.prefill_chunk``, whose causal chunk attends past pool
  pages plus its own prefix and writes its K/V straight into the pool
  (in-kernel with ``paged_attn=True``).  The final chunk samples the first
  token and the row joins decode in the same segment.
* **Decode segments** -- up to ``segment_len`` fused decode+sample steps
  over the whole batch as a Python loop that exits early once every row is
  done (one host read of the done mask per step), then one harvest of the
  row state per segment.  The host joins, retires and admits between
  segments.
* **Preemption** -- ``'recompute'`` (default) admits on actual prompt
  blocks and, when decode growth finds the pool exhausted, evicts the
  newest-admitted request and later re-prefills it (fp pools: prompt plus
  tokens generated so far; int8 pools: a full restart), keeping its
  stream bit-identical; ``'off'`` reserves the worst case at admission.
  ``'page_out'`` instead copies the victim's written pool blocks (exact
  bytes: int8 codes and bf16 scales, or fp pages) and its host cursors,
  the pending token included, into a host :class:`~repro_torch.serve.
  kv_pool.SpillStore`; re-admission scatters them into fresh blocks and
  the row rejoins decode with no prefill.  A victim caught mid-chunked-
  prefill falls back to recompute.
* **Prefix cache** (``prefix_cache=True``, a preemptive mode) -- full
  prompt blocks are indexed by a chained token hash; admission maps the
  longest cached prefix at refcount + 1 and prefills only the unique
  suffix (blocking: one B = 1 ``model.prefill_chunk`` over the past
  pages; chunked: the chunk cursor starts past the shared blocks).  An
  exact-full-prompt hit copies the shared tail page at admission
  (copy-on-write) and recomputes its last block's logits without
  rewriting the copied bytes.  ``Request.priority`` steers admission
  order and victim choice.
* **Lifecycle** -- deadlines, :meth:`ContinuousEngine.cancel`, a bounded
  queue (``max_queue``) and the non-finite-logits guard retire requests as
  TIMEOUT / CANCELLED / SHED / FAILED with all blocks returned.
* **Fault injection** -- ``run_stream(..., faults=FaultInjector(...))``
  (``serve/faults.py``) drives hidden pool blocks, forced preemptions,
  poisoned logits, cancels, cache flushes and crash points through the
  real code paths.
* **Snapshot / restore / drain** -- every scheduler round starts at a
  segment boundary, where host state is consistent.  ``snapshot_dir`` +
  ``snapshot_interval`` checkpoint these boundaries to an ``.npz``
  (``serve/snapshot.py``, the JAX package's format); a new engine of the
  same geometry :meth:`~ContinuousEngine.restore` s the file and
  :meth:`~ContinuousEngine.resume` s every in-flight request
  bit-identically.  :meth:`~ContinuousEngine.drain` stops admissions,
  lets running requests finish until a deadline, spills the stragglers
  (page_out) and writes a final snapshot.
* **Seeded sampling** -- ``run(key=..., temperature=...)`` samples each
  row with ``fold_in(fold_in(key, rid), step)`` (``serve/prng.py``), so a
  request's stream is independent of its batch neighbours and equal to
  the JAX engine's at the same key.

Idle and finished rows still occupy compute lanes within a segment; their
page writes are masked to the null block and their outputs discarded.
Each segment hands the device only the pow2-bucketed live-width prefix of
the block tables, and the engine defrags adaptively so tables stay
contiguous.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backend as backend_lib
from repro_torch.kernels import autotune
from repro_torch.models import model as model_lib
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import kv_pool, prng
from repro_torch.serve import snapshot as snapshot_lib
from repro_torch.serve import telemetry as telemetry_lib
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import (Request, RequestStatus,
                                         ScheduledRequest, Scheduler, State)


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray            # [n_out] int32
    logprobs: np.ndarray          # [n_out] float32
    finish_reason: str            # 'stop' | 'length' | a non-OK status value
    arrival_step: int
    admitted_step: int
    first_token_step: int
    finished_step: int
    ttft_seconds: float = float("nan")
    status: RequestStatus = RequestStatus.OK
    n_preemptions: int = 0

    @property
    def latency_steps(self) -> int:
        return self.finished_step - self.arrival_step

    @property
    def ttft_steps(self) -> int:
        return self.first_token_step - self.arrival_step


@dataclasses.dataclass
class _RunState:
    """Everything one serve run owns besides the device pages: scheduler,
    host row arrays, emitted streams and the sim clock.  A snapshot is a
    serialization of this record (plus pages, allocator and spill store)
    at a segment boundary; ``restore`` rebuilds it so ``resume`` re-enters
    the same loop."""
    sched: Scheduler
    requests: dict[int, Request]
    rng: torch.Tensor             # the run's sampler key (serve/prng.py)
    temperature: float
    greedy: bool
    stop_w: int
    tok: np.ndarray               # [mb] pending (sampled, unemitted) token
    n_out: np.ndarray             # [mb] emitted counts (post-harvest)
    lens: np.ndarray              # [mb] cache positions written
    done: np.ndarray              # [mb] idle/finished row mask
    rids: np.ndarray              # [mb]
    max_new: np.ndarray           # [mb]
    stops: np.ndarray             # [mb, stop_w]
    tables: np.ndarray            # [mb, max_blocks_per_req]
    streams: dict[int, tuple[list, list]]
    now: int = 0                  # sim clock (decode steps)
    n_loops: int = 0              # scheduler rounds completed
    drain_at: int | None = None   # sim deadline of an active drain
    drain_path: str | None = None


class ContinuousEngine:
    """Continuous-batching engine over a paged KV pool of ``kv_blocks``
    blocks of ``block_size`` tokens on ``device`` (dense-attention archs;
    the int8 pool follows ``cfg.kv_cache_dtype``).

    With ``prefix_cache=True`` (requires a preemptive mode) the pool is
    content-addressable: full prompt blocks are indexed by a chained
    token hash, admissions map the longest cached prefix at refcount+1
    and prefill only the unique suffix, an exact-full-prompt hit
    copy-on-writes the shared tail block, and ``Request.priority``
    classes steer both admission order and victim selection.  Token
    streams are identical to the uncached engine's.

    ``keep_first_logits=True`` keeps, in ``first_logits`` ({rid: [V]
    f32}), the logits a request's first token is sampled from (a
    blocking admission's full or suffix prefill, a chunked prefill's
    final chunk), the latest admission's where a request is admitted
    again: what a caller compares cached and full prefill by."""

    def __init__(self, params, cfg, *, plan=None, mode=None,
                 max_batch: int = 8, kv_blocks: int = 64,
                 block_size: int = 16, max_blocks_per_req: int | None = None,
                 segment_len: int = 8, seq_bucket: int = 32,
                 defrag_interval: int | None = None,
                 defrag_threshold: float | None = 0.5,
                 defrag_min_holes: int = 4,
                 paged_attn: bool = False,
                 chunked_prefill: bool = False,
                 prefill_chunk: int | None = None,
                 preemption: str = "recompute",
                 prefix_cache: bool = False,
                 max_queue: int | None = None,
                 debug_invariants: bool = False,
                 telemetry=None,
                 trace_samples: int = 4096,
                 profiler_annotations: bool = False,
                 snapshot_dir: str | None = None,
                 snapshot_interval: int | None = None,
                 keep_first_logits: bool = False,
                 device="cuda"):
        if cfg.arch_type != "dense" or cfg.sliding_window is not None:
            raise ValueError(
                "continuous batching serves dense-attention archs without "
                f"sliding windows (got {cfg.arch_type!r}, "
                f"window={cfg.sliding_window})")
        if cfg.mrope_sections is not None:
            raise ValueError(
                "continuous batching does not support M-RoPE archs: paged "
                "decode derives per-row positions from the pool lengths, "
                "which has no 3-axis (t/h/w) position layout")
        if preemption not in ("off", "recompute", "page_out"):
            raise ValueError("preemption must be 'off' (worst-case "
                             "reservation), 'recompute' (preempt + "
                             "re-prefill), or 'page_out' (spill victim KV "
                             f"to the host, no recompute), got "
                             f"{preemption!r}")
        if snapshot_interval is not None:
            if snapshot_interval < 1:
                raise ValueError(
                    f"snapshot_interval must be >= 1, got {snapshot_interval}")
            if snapshot_dir is None:
                raise ValueError(
                    "snapshot_interval requires snapshot_dir (where else "
                    "would the periodic checkpoints land?)")
        if prefix_cache and preemption == "off":
            raise ValueError(
                "prefix_cache requires a preemptive mode ('recompute' or "
                "'page_out'): reservation admission sizes every request "
                "for its worst case, so shared blocks would break the "
                "free-list accounting")
        self.device = device_lib.resolve(device)
        if plan is None and mode is not None:
            plan = backend_lib.as_plan(mode)
        if paged_attn:
            plan = dataclasses.replace(backend_lib.as_plan(plan),
                                       paged_attn=True)
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.max_batch = max_batch
        self.block_size = block_size
        self.segment_len = segment_len
        self.chunked_prefill = chunked_prefill
        self.preemption = preemption
        self.prefix_cache = bool(prefix_cache)
        self.max_queue = max_queue
        self.debug_invariants = debug_invariants
        self.first_logits: dict[int, torch.Tensor] | None = (
            {} if keep_first_logits else None)
        self._chunk_logits = None   # the last prefill chunk's, if kept
        self._int8_pool = getattr(cfg, "kv_cache_dtype", "bf16") == "int8"
        heads = dict(head_dim=cfg.resolved_head_dim,
                     groups=cfg.n_heads // cfg.n_kv_heads)
        if prefill_chunk is None:
            # The JAX package's key: an fp pool counts as float32.
            prefill_chunk = autotune.choose_prefill_chunk(
                max_batch, cfg.n_kv_heads, block_size,
                torch.int8 if self._int8_pool else torch.float32, **heads)
        if prefill_chunk % block_size != 0 or prefill_chunk < block_size:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive "
                f"multiple of block_size ({block_size}) so chunk starts "
                "stay page-aligned")
        self.prefill_chunk = int(prefill_chunk)
        self.defrag_interval = defrag_interval
        self.defrag_threshold = defrag_threshold
        self.defrag_min_holes = defrag_min_holes
        self.max_blocks_per_req = (kv_blocks - 1 if max_blocks_per_req is None
                                   else max_blocks_per_req)
        self.max_seq_len = self.max_blocks_per_req * block_size
        # On the card the decode kernel's pages per split are fixed for
        # the widest table (a measured split at this engine's key, else
        # the card's heuristic), so a request decodes to the same bits at
        # every live table width (page-out and restore stay exact); the
        # CPU keeps the JAX package's split choice.
        self.split_pages = (autotune.paged_split_pages(
            max_batch, cfg.n_kv_heads, self.max_blocks_per_req,
            device_lib.sm_count(self.device), block_size=block_size,
            dtype=(torch.int8 if self._int8_pool else torch.bfloat16
                   if cfg.dtype == "bfloat16" else torch.float32), **heads)
            if self.device.type == "cuda" else None)
        # The inner engine's max_len bounds blocking prefill's prompt
        # buckets, as in the JAX package.
        self.engine = Engine(params, cfg, max_len=self.max_seq_len,
                             plan=plan, seq_bucket=seq_bucket,
                             device=self.device)
        self.allocator = kv_pool.BlockAllocator(kv_blocks)
        self.pages = self._empty_pages(kv_blocks)
        self._cancel_req: set[int] = set()
        # Durability: the host spill store (page-out preemption), the
        # periodic snapshot config and the restore/resume handshake.
        self.spill = kv_pool.SpillStore()
        self.snapshot_dir = snapshot_dir
        self.snapshot_interval = snapshot_interval
        self.last_snapshot_path: str | None = None
        self._run_state: _RunState | None = None
        self._restored: _RunState | None = None
        self._at_boundary = False
        self._drain_req: tuple[int, str | None] | None = None
        if isinstance(telemetry, telemetry_lib.Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = telemetry_lib.Telemetry(
                enabled=True if telemetry is None else bool(telemetry),
                trace_samples=trace_samples,
                profiler_annotations=profiler_annotations)

    def _empty_pages(self, num_blocks: int):
        dtype = (torch.bfloat16 if self.cfg.dtype == "bfloat16"
                 else torch.float32)
        return kv_pool.init_pages(self.cfg, num_blocks, self.block_size,
                                  dtype, device=self.device)

    # ------------------------------------------------------------ telemetry

    @property
    def metrics(self) -> telemetry_lib.MetricsRegistry:
        return self.telemetry.metrics

    @property
    def tracer(self) -> telemetry_lib.Tracer:
        return self.telemetry.tracer

    @property
    def dispatch_count(self) -> int:
        return self.metrics.value("serve_lifetime_dispatches_total")

    @property
    def last_run_ttft_seconds(self) -> dict[int, float]:
        return self.telemetry.ttft_seconds

    @property
    def occupancy_trace(self):
        return self.telemetry.occupancy_trace

    @property
    def fragmentation_trace(self):
        return self.telemetry.fragmentation_trace

    def export_metrics(self, path: str) -> None:
        self.metrics.write(path)

    def export_trace(self, path: str) -> None:
        self.tracer.write(path)

    def ttft_percentile(self, pct: float) -> float:
        return telemetry_lib.percentile(
            self.telemetry.ttft_seconds.values(), pct)

    def cancel(self, rid: int) -> None:
        """Request cancellation of `rid`, honored at the next scheduler
        round (running or queued; unknown / finished rids are ignored)."""
        self._cancel_req.add(rid)

    def _dispatch(self, fn, *args, name: str = "dispatch"):
        self.metrics.counter("serve_dispatches_total").inc()
        self.metrics.counter("serve_lifetime_dispatches_total").inc()
        with self.telemetry.annotate(f"serve/{name}"):
            return fn(*args)

    # ------------------------------------------------------------- segments

    def _decode_loop(self, step, seg_len: int):
        """Shared decode-segment body: up to `seg_len` fused decode+sample
        steps over the whole batch, exiting early when every row is done.
        A row whose step returns non-finite logits has that step's emission
        retracted and is marked failed+done."""
        def seg(params, pages, tables, tok, n_out, lens, done, failed,
                rids, max_new, stops, poison, rng, temperature, pad_token):
            mb = tok.shape[0]
            dev = tok.device
            out_t = torch.full((mb, seg_len), pad_token, dtype=torch.int32,
                               device=dev)
            out_lp = torch.zeros((mb, seg_len), dtype=torch.float32,
                                 device=dev)
            i = 0
            while i < seg_len and not bool(done.all()):
                out_t[:, i] = torch.where(done, pad_token, tok)
                caches = {"kv": pages, "block_tables": tables, "lens": lens,
                          "write_mask": ~done,
                          "split_pages": self.split_pages}
                nxt, lp, ok, caches = step(params, tok, caches, rng, rids,
                                           n_out + 1, temperature, poison)
                bad = ~ok & ~done
                out_t[:, i] = torch.where(bad, pad_token, out_t[:, i])
                out_lp[:, i] = torch.where(done | bad, 0.0, lp)
                live = (~done & ~bad).to(torch.int32)
                lens = lens + live
                n_out = n_out + live
                failed = failed | bad
                done = done | bad | (tok[:, None] == stops).any(dim=-1) \
                    | (n_out >= max_new)
                tok = nxt
                i += 1
            return pages, tok, n_out, lens, done, failed, out_t, out_lp, i

        return seg

    def _segment_fn(self, plan, greedy: bool, seg_len: int):
        """A pure decode segment over the paged-pool cache view."""
        loop = self._decode_loop(self.engine.make_step(plan, greedy),
                                 seg_len)

        def seg(params, pages, tables, tok, n_out, lens, done, rids,
                max_new, stops, poison, rng, temperature, pad_token):
            failed = torch.zeros_like(done)
            return loop(params, pages, tables, tok, n_out, lens, done,
                        failed, rids, max_new, stops, poison, rng,
                        temperature, pad_token)

        return seg

    def _mixed_segment_fn(self, plan, greedy: bool, seg_len: int,
                          has_past: bool):
        """A chunked-prefill prologue over the ``pb``-row sub-batch of
        prefilling rows (their final chunk samples the first token and the
        row joins decode) followed by the decode segment.  Padding entries
        of the sub-batch point at a non-prefilling row and write its own
        current value back, a deterministic no-op.  ``pf_nw`` marks rows
        whose chunk span is a copy-on-write page that already holds exact
        K/V: their logits are computed, their page writes masked."""
        cfg = self.cfg
        sample = self.engine.make_sample(plan, greedy)
        loop = self._decode_loop(self.engine.make_step(plan, greedy),
                                 seg_len)

        def seg(params, pages, tables, pf_rows, pf_tables, pf_tok, pf_pos,
                pf_cnt, pf_on, pf_nw, pf_fin, pf_t0, tok, n_out, lens, done,
                rids, max_new, stops, poison, rng, temperature, pad_token):
            logits0, pages = model_lib.prefill_chunk(
                params, pf_tok, cfg, pages=pages, block_tables=pf_tables,
                pos=pf_pos, n_tok=pf_cnt, write_mask=pf_on & ~pf_nw,
                has_past=has_past, mode=plan)
            if self.first_logits is not None:
                self._chunk_logits = logits0
            logits0 = torch.where(poison[pf_rows][:, None], torch.nan,
                                  logits0)
            ok0 = torch.isfinite(logits0.to(torch.float32)).all(dim=-1)
            tok0 = sample(logits0, rng, rids[pf_rows], pf_t0, temperature)
            fin = pf_on & pf_fin
            good = fin & ok0
            bad = fin & ~ok0
            tok = tok.clone()
            done = done.clone()
            lens = lens.clone()
            tok[pf_rows] = torch.where(good, tok0, tok[pf_rows])
            done[pf_rows] = done[pf_rows] & ~good
            lens[pf_rows] = torch.where(pf_on, pf_pos + pf_cnt,
                                        lens[pf_rows])
            failed = torch.zeros_like(done)
            failed[pf_rows] = bad
            return loop(params, pages, tables, tok, n_out, lens, done,
                        failed, rids, max_new, stops, poison, rng,
                        temperature, pad_token)

        return seg

    # ------------------------------------------------------------------ run

    def _maybe_defrag(self, sched: Scheduler, tables: np.ndarray,
                      now: int = -1) -> np.ndarray:
        """Compact live blocks onto the lowest page slots; rewrites the row
        block tables AND every running request's block list."""
        if not self.allocator.fragmented:
            return tables
        t0 = self.tracer.now()
        remap = self.allocator.defrag()
        if remap:
            self.pages, tables = kv_pool.apply_defrag(
                self.pages, tables, remap)
            for sr in sched.running.values():
                sr.blocks = [remap.get(b, b) for b in sr.blocks]
            self.metrics.counter("serve_defrags_total").inc()
            self.tracer.span("defrag", t0, self.tracer.now(), cat="pool",
                             args={"step": now, "moved": len(remap)})
        return tables

    def _scheduler(self) -> Scheduler:
        return Scheduler(self.allocator, self.max_batch, self.block_size,
                         preemptive=self.preemption != "off",
                         prefix_cache=self.prefix_cache,
                         max_queue=self.max_queue,
                         debug=self.debug_invariants, metrics=self.metrics)

    def run(self, requests: Sequence[Request], *, key=None,
            temperature: float = 0.0, faults=None
            ) -> dict[int, RequestResult]:
        """Serve a request stream to completion; returns {rid: result}."""
        results: dict[int, RequestResult] = {}
        for ev in self.run_stream(requests, key=key,
                                  temperature=temperature, faults=faults):
            if ev["event"] == "finish":
                results[ev["rid"]] = ev["result"]
        return results

    def run_stream(self, requests: Sequence[Request], *, key=None,
                   temperature: float = 0.0,
                   faults=None) -> Iterator[dict]:
        """Generator form of :meth:`run`: yields 'admit' | 'tokens' |
        'preempt' | 'finish' | 'drain' events as the sim advances.
        ``faults`` is an optional chaos driver (``serve/faults.py``): its
        per-round action dict is applied through the real scheduler,
        allocator and sampler code paths."""
        requests = list(requests)
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("request ids must be unique within a run "
                             "(they seed the per-request RNG)")
        for r in requests:
            if r.prompt_len + r.max_new > self.max_seq_len:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + max_new "
                    f"{r.max_new} exceeds max_blocks_per_req * block_size "
                    f"= {self.max_seq_len}")
        greedy = temperature <= 0 or key is None
        rng = (prng.PRNGKey(0, device=self.device) if key is None
               else prng.as_key(key, self.device))
        stop_w = max((len(r.stop_tokens) for r in requests), default=0) or 1
        self._cancel_req = set()
        self._restored = None
        self.telemetry.reset_run()
        sched = self._scheduler()
        for r in sorted(requests, key=lambda r: r.arrival_step):
            sched.submit(r)
        mb, nbr = self.max_batch, self.max_blocks_per_req
        st = _RunState(
            sched=sched, requests={r.rid: r for r in requests}, rng=rng,
            temperature=float(temperature), greedy=greedy, stop_w=stop_w,
            tok=np.zeros(mb, np.int32), n_out=np.zeros(mb, np.int32),
            lens=np.zeros(mb, np.int32), done=np.ones(mb, bool),
            rids=np.zeros(mb, np.int32), max_new=np.zeros(mb, np.int32),
            stops=np.full((mb, stop_w), -1, np.int32),
            tables=np.zeros((mb, nbr), np.int32), streams={})
        yield from self._drive(st, faults)

    def _drive(self, st: _RunState, faults) -> Iterator[dict]:
        """Run the serve loop over a (fresh or restored) run state with the
        end-of-run cleanup both paths share."""
        self._run_state = st
        try:
            yield from self._serve_loop(st, faults)
        finally:
            # An abandoned stream or a CrashPoint releases every in-flight
            # request's blocks (running and preempted), returns any
            # fault-hidden blocks and drops host spill entries, so the
            # allocator is exactly full for the next run.  Crash recovery
            # reads the snapshot file, never this in-memory state.
            self._run_state = None
            self._at_boundary = False
            self._drain_req = None
            self.allocator.unhide_all()
            for sr in list(st.sched.running.values()):
                st.sched.finish(sr, -1)
            for sr in list(st.sched.preempted):
                st.sched.finish(sr, -1)
            self.spill.clear()

    # ----------------------------------------------------------- durability

    def snapshot(self, path: str) -> str:
        """Serialize the active run at its current segment boundary (see
        ``serve/snapshot.py``).  Valid on a restored-not-yet-resumed
        engine; during a run use ``snapshot_dir`` + ``snapshot_interval``
        or :meth:`drain` -- between events the loop is suspended mid-round
        and host state is not snapshot-consistent."""
        st = self._run_state
        if st is None:
            raise RuntimeError(
                "snapshot() requires an active or restored run (nothing to "
                "serialize on an idle engine)")
        if not self._at_boundary:
            raise RuntimeError(
                "snapshot() is only valid at a segment boundary — use "
                "snapshot_dir/snapshot_interval for periodic in-run "
                "checkpoints, or drain() for a final one")
        return self._write_snapshot(st, path=path)

    def _write_snapshot(self, st: _RunState, path: str | None = None) -> str:
        if path is None:
            path = os.path.join(self.snapshot_dir, "serve_snap.npz")
        t0 = self.tracer.now()
        path = snapshot_lib.save_snapshot(path, engine=self, state=st)
        self.last_snapshot_path = path
        self.metrics.counter("serve_snapshots_total").inc()
        self.tracer.span("snapshot", t0, self.tracer.now(), cat="durability",
                         args={"step": st.now, "round": st.n_loops,
                               "path": str(path)})
        return path

    def restore(self, path: str) -> "ContinuousEngine":
        """Load a snapshot (this package's or the JAX package's) into this
        engine: allocator books, pool pages (live blocks scattered back),
        spill store, scheduler queues and the run state; then
        :meth:`resume` / :meth:`resume_stream` continues every in-flight
        request bit-identically.  The engine must be idle and built with
        the snapshot's geometry (checked); pass the same params, cfg and
        plan -- weights are not in the file."""
        if self._run_state is not None and self._restored is None:
            raise RuntimeError("restore() on an engine with an active run")
        meta, arrays = snapshot_lib.load_snapshot(path)
        snapshot_lib.check_geometry(self, meta["geometry"])
        self.allocator = kv_pool.BlockAllocator.from_state(meta["allocator"])
        self.pages = self._empty_pages(self.allocator.num_blocks)
        live = [int(b) for b in meta["live_blocks"]]
        if live:
            pool_kv = {k[len("pool_"):]: v for k, v in arrays.items()
                       if k.startswith("pool_")}
            self.pages = kv_pool.insert_blocks(self.pages, pool_kv, live)
        # A cached-free prefix entry whose bytes the file lacks (the JAX
        # package saves live blocks only) would map zeroed pages: drop it.
        self.allocator.drop_cached(keep=live)
        self.spill = kv_pool.SpillStore()
        for srid, e in meta["spill"].items():
            rid = int(srid)
            self.spill.put(rid, kv_pool.SpillEntry(
                kv={k: arrays[f"spill_{rid}_{k}"] for k in e["kv_keys"]},
                n_blocks=int(e["n_blocks"]), ctx_len=int(e["ctx_len"]),
                n_out=int(e["n_out"]), pending_tok=int(e["pending_tok"])))
        requests: dict[int, Request] = {}
        for rm in meta["requests"]:
            rid = int(rm["rid"])
            requests[rid] = Request(
                rid=rid, prompt=arrays[f"prompt_{rid}"],
                max_new=int(rm["max_new"]),
                arrival_step=int(rm["arrival_step"]),
                stop_tokens=tuple(int(t) for t in rm["stop_tokens"]),
                deadline_steps=rm["deadline_steps"],
                priority=int(rm.get("priority", 0)))
        sched = self._scheduler()
        sched.load_state(
            meta["scheduler"], requests,
            {int(k[len("resume_"):]): v for k, v in arrays.items()
             if k.startswith("resume_")})
        run = meta["run"]
        streams = {
            int(rid): ([int(t) for t in arrays[f"stream_tok_{rid}"]],
                       [float(x) for x in arrays[f"stream_lp_{rid}"]])
            for rid in meta["streams"]}
        st = _RunState(
            sched=sched, requests=requests,
            rng=prng.as_key(arrays["rng"], self.device),
            temperature=float(run["temperature"]),
            greedy=bool(run["greedy"]), stop_w=int(run["stop_w"]),
            tok=np.array(arrays["tok"]), n_out=np.array(arrays["n_out"]),
            lens=np.array(arrays["lens"]), done=np.array(arrays["done"]),
            rids=np.array(arrays["rids"]),
            max_new=np.array(arrays["max_new"]),
            stops=np.array(arrays["stops"]),
            tables=np.array(arrays["tables"]), streams=streams,
            now=int(run["now"]), n_loops=int(run["n_loops"]))
        self._run_state = st
        self._restored = st
        self._at_boundary = True
        self.last_snapshot_path = str(path)
        return self

    def resume_stream(self, *, faults=None) -> Iterator[dict]:
        """Continue a :meth:`restore` d run: the event stream picks up at
        the snapshot's segment boundary, and every request the snapshot
        holds in flight (running / preempted / spilled / queued) completes
        with the token stream an uninterrupted run would have produced."""
        st = self._restored
        if st is None:
            raise RuntimeError(
                "resume_stream() requires a prior restore(path)")
        self._restored = None
        self._cancel_req = set()
        self._at_boundary = False
        self.telemetry.reset_run()
        sched = st.sched
        n_flight = (len(sched.running) + len(sched.preempted)
                    + len(sched.arrived) + len(sched.pending))
        self.metrics.counter("serve_recoveries_total").inc(n_flight)
        self.tracer.instant(
            "recover", cat="durability",
            args={"step": st.now, "round": st.n_loops,
                  "in_flight": n_flight, "spilled": len(self.spill),
                  "path": self.last_snapshot_path})
        yield from self._drive(st, faults)

    def resume(self) -> dict[int, RequestResult]:
        """Blocking form of :meth:`resume_stream`; returns {rid: result}
        for every request that retires after the restore point."""
        results: dict[int, RequestResult] = {}
        for ev in self.resume_stream():
            if ev["event"] == "finish":
                results[ev["rid"]] = ev["result"]
        return results

    def drain(self, deadline_steps: int, path: str | None = None) -> None:
        """Begin a graceful drain of the active run: admissions stop
        (queued arrivals are checkpointed as queued), running requests get
        up to ``deadline_steps`` more sim steps to finish, stragglers are
        spilled (page_out mode) or checkpointed in place, and a final
        snapshot lands at ``path`` (default ``snapshot_dir/
        serve_snap.npz``).  The run then ends with a ``'drain'`` event; a
        warm restart restores the file and serves the remainder."""
        if deadline_steps < 0:
            raise ValueError(f"drain deadline must be >= 0, "
                             f"got {deadline_steps}")
        if path is None and self.snapshot_dir is None:
            raise ValueError("drain() needs an explicit path or an engine "
                             "snapshot_dir")
        self._drain_req = (int(deadline_steps), path)

    # ------------------------------------------------------------- lifecycle

    def _retire_unadmitted(self, req: Request, status: RequestStatus,
                           now: int) -> dict:
        result = RequestResult(
            rid=req.rid, tokens=np.zeros(0, np.int32),
            logprobs=np.zeros(0, np.float32), finish_reason=status.value,
            arrival_step=req.arrival_step, admitted_step=-1,
            first_token_step=-1, finished_step=now, status=status)
        self.metrics.counter(
            "serve_requests_total", "Requests retired, by terminal status",
            labels={"status": status.value}).inc()
        self.tracer.request_retire(req.rid, status.value, step=now,
                                   n_tokens=0)
        return {"event": "finish", "rid": req.rid, "step": now,
                "result": result}

    def _retire_record(self, st: _RunState, sr: ScheduledRequest,
                       status: RequestStatus, now: int) -> dict:
        row = sr.row
        st.sched.finish(sr, now)
        self.spill.discard(sr.rid)
        if row >= 0:
            st.tables[row] = kv_pool.NULL_BLOCK
            st.lens[row] = 0
            st.done[row] = True
        toks, lps = st.streams.pop(sr.rid, ([], []))
        result = RequestResult(
            rid=sr.rid, tokens=np.asarray(toks, np.int32),
            logprobs=np.asarray(lps, np.float32),
            finish_reason=status.value, arrival_step=sr.req.arrival_step,
            admitted_step=sr.admitted_step,
            first_token_step=sr.first_token_step,
            finished_step=sr.finished_step,
            ttft_seconds=self.last_run_ttft_seconds.get(sr.rid,
                                                        float("nan")),
            status=status, n_preemptions=sr.n_preempt)
        self.metrics.counter(
            "serve_requests_total", "Requests retired, by terminal status",
            labels={"status": status.value}).inc()
        self.tracer.request_retire(sr.rid, status.value, step=now,
                                   n_tokens=len(toks))
        return {"event": "finish", "rid": sr.rid, "step": now,
                "result": result}

    def _preempt_one(self, st: _RunState, victim: ScheduledRequest,
                     now: int) -> Iterator[dict]:
        """Evict one running request, free its blocks, clear its row and
        requeue it.  Three resume flavors, all bit-identical:

        * page_out (victim not mid-chunked-prefill) -- the victim's written
          KV blocks (exact bytes) and its host cursors go to the
          SpillStore; re-admission scatters them into fresh blocks and
          decode continues with no recompute.
        * fp recompute -- re-admission prefills the original prompt plus
          every token generated so far and re-samples the pending token
          at the same (key, rid, step) triple.
        * int8 recompute -- a full restart from the original prompt with
          ``n_out = 0`` (decode reads dequantized codes a stapled prefill
          could not reproduce).

        Emits the 'preempt' event plus any overload fallout (a shed
        arrival evicted from a full queue, or the victim itself dropped as
        PREEMPTED when the queue holds only preempted peers)."""
        sched = st.sched
        row = victim.row
        spill = (self.preemption == "page_out"
                 and not (self.chunked_prefill
                          and victim.state is State.PREFILL))
        if spill:
            # Spill exactly the blocks that hold written positions; growth
            # blocks past ctx hold no live state.
            ctx = int(st.lens[row])
            nb = kv_pool.blocks_for(max(ctx, 1), self.block_size)
            t0 = self.tracer.now()
            entry = kv_pool.SpillEntry(
                kv=kv_pool.extract_blocks(self.pages, victim.blocks[:nb]),
                n_blocks=nb, ctx_len=ctx, n_out=victim.n_out,
                pending_tok=int(st.tok[row]))
            self.spill.put(victim.rid, entry)
            self.metrics.counter("serve_spills_total").inc()
            self.metrics.counter("serve_spill_bytes_total").inc(entry.nbytes)
            self.tracer.span(
                "spill", t0, self.tracer.now(), cat="durability",
                args={"step": now, "rid": victim.rid, "blocks": nb,
                      "bytes": entry.nbytes})
            victim.resume_prompt = None
            requeued, evicted = sched.preempt(victim, now, spill_blocks=nb)
        else:
            emitted = st.streams.get(victim.rid, ([], []))
            if not self._int8_pool:
                victim.resume_prompt = np.concatenate(
                    [np.asarray(victim.req.prompt, np.int32),
                     np.asarray(emitted[0], np.int32)])
            requeued, evicted = sched.preempt(victim, now)
        st.tables[row] = kv_pool.NULL_BLOCK
        st.lens[row] = 0
        st.done[row] = True
        self.metrics.counter("serve_preemptions_total").inc()
        self.tracer.request_point(victim.rid, "preempt", step=now,
                                  n_out=victim.n_out, spilled=spill)
        yield {"event": "preempt", "rid": victim.rid, "step": now,
               "n_out": victim.n_out, "spilled": spill}
        if evicted is not None:
            self.metrics.counter("serve_sheds_total").inc()
            yield self._retire_unadmitted(evicted, RequestStatus.SHED, now)
        if not requeued:
            yield self._retire_record(st, victim, RequestStatus.PREEMPTED,
                                      now)
        elif not spill and self._int8_pool:
            st.streams.pop(victim.rid, None)
            victim.resume_prompt = None
            victim.n_out = 0

    def _grow(self, st: _RunState, sr: ScheduledRequest, target: int,
              now: int):
        """Grow sr's blocks to cover `target` positions, preempting
        newest-admitted victims until the pool yields; returns the new
        blocks, or None when sr itself had to be preempted."""
        while True:
            got = st.sched.ensure_capacity(sr, target)
            if got is not None:
                return got
            victim = st.sched.pick_victim(exclude_rid=sr.rid) or sr
            yield from self._preempt_one(st, victim, now)
            if victim is sr:
                return None

    def _cow_copy(self, src: int, dst: int, rid: int, now: int) -> None:
        """The device page copy of copy-on-write, with its metric and
        span.  Queued on the device before any later prefill that could
        recycle ``src``."""
        tc = self.tracer.now()
        self.pages = self._dispatch(kv_pool.copy_block, self.pages, src,
                                    dst, name="cow_copy")
        self.metrics.counter("serve_cow_copies_total").inc()
        self.tracer.span("cow_copy", tc, self.tracer.now(), cat="pool",
                         args={"step": now, "rid": rid, "src": src,
                               "dst": dst})

    def _cow_writes(self, st: _RunState, sr: ScheduledRequest, start: int,
                    end: int, now: int, tables: np.ndarray) -> Iterator[dict]:
        """Copy-on-write guard for a segment's upcoming writes: any block
        in sr's write span [start, end) still referenced elsewhere gets a
        private copy (alloc, page copy, table swap, decref) before the
        dispatch that would write it.  Admission already un-shares the only
        organically shared write target (the exact-hit tail), so this
        normally never fires; it makes 'decode never corrupts a sharer' a
        checked property."""
        bs = self.block_size
        for i in range(start // bs,
                       min(kv_pool.blocks_for(end, bs), len(sr.blocks))):
            src = sr.blocks[i]
            if self.allocator.refcount(src) <= 1:
                continue
            while True:
                got = self.allocator.alloc(1)
                if got is not None:
                    break
                victim = st.sched.pick_victim(exclude_rid=sr.rid)
                if victim is None:
                    raise RuntimeError(
                        "copy-on-write guard: pool exhausted with no "
                        f"victim (rid={sr.rid}, block={src})")
                yield from self._preempt_one(st, victim, now)
            dst = got[0]
            self._cow_copy(src, dst, sr.rid, now)
            sr.blocks[i] = dst
            tables[sr.row, i] = dst
            self.allocator.free([src])

    # ------------------------------------------------------------ main loop

    def _serve_loop(self, st: _RunState, faults) -> Iterator[dict]:
        sched = st.sched
        plan = self.plan
        greedy = st.greedy
        dev = self.device
        rng = st.rng
        temp = torch.tensor(max(st.temperature, 1e-6), dtype=torch.float32,
                            device=dev)
        chunked = self.chunked_prefill
        pad = -1
        seg_fn = self._segment_fn(plan, greedy, self.segment_len)
        # Hot locals alias the run-state arrays; the rebinding sites
        # (defrag's table rewrite, the harvest) sync st.* at once, so st is
        # always what the preempt/retire helpers and the snapshot see.
        tok, n_out, lens, done = st.tok, st.n_out, st.lens, st.done
        rids, max_new, stops, tables = (st.rids, st.max_new, st.stops,
                                        st.tables)
        streams = st.streams
        now = st.now
        n_loops = st.n_loops
        n_stalled = 0
        chunk = self.prefill_chunk
        mb = tok.shape[0]
        eligible_wall: dict[int, float] = {}

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        while sched.has_work:
            n_loops += 1
            t_round = time.perf_counter()
            poison_rids: set[int] = set()

            # ---- segment boundary: every device result is harvested and
            # host state is consistent, the only place a snapshot is
            # sound.  Sync the run state, then checkpoint on the periodic
            # cadence and finish an elapsed drain.
            st.tok, st.n_out, st.lens, st.done = tok, n_out, lens, done
            st.tables = tables
            st.now, st.n_loops = now, n_loops
            self._at_boundary = True
            if self._drain_req is not None and st.drain_at is None:
                st.drain_at = now + self._drain_req[0]
                st.drain_path = self._drain_req[1]
                self._drain_req = None
                self.tracer.instant(
                    "drain_start", cat="durability",
                    args={"step": now, "deadline": st.drain_at})
            if st.drain_at is not None and (now >= st.drain_at
                                            or not sched.running):
                # Deadline hit or the batch quiesced: spill the stragglers
                # (page_out; other modes checkpoint them running or queued
                # as they are), write the final snapshot, end the run.
                if self.preemption == "page_out":
                    while sched.running:
                        victim = sched.pick_victim()
                        yield from self._preempt_one(st, victim, now)
                path = self._write_snapshot(st, path=st.drain_path)
                self._at_boundary = False
                yield {"event": "drain", "step": now, "path": path,
                       "running": len(sched.running),
                       "spilled": len(self.spill),
                       "queued": sched.queue_len}
                return
            if (self.snapshot_interval
                    and (n_loops - 1) % self.snapshot_interval == 0):
                self._write_snapshot(st)
            self._at_boundary = False

            # ---- fault hook: chaos actions ride the real code paths ----
            if faults is not None:
                acts = faults.on_round(
                    n_loops - 1, now,
                    [sr.rid for sr in sched.running.values()],
                    [r.rid for r in sched.arrived]
                    + [s.rid for s in sched.preempted])
                for ev_name, ev_args in faults_lib.describe(acts):
                    self.tracer.instant(ev_name, cat="fault",
                                        args={"step": now, **ev_args})
                if acts.get("crash"):
                    # Simulated hard death: no retires, no finish events;
                    # recovery must come from the last snapshot file.
                    raise faults_lib.CrashPoint(n_loops - 1, now)
                if acts.get("unhide"):
                    self.allocator.unhide_all()
                if acts.get("hide"):
                    self.allocator.hide_blocks(int(acts["hide"]))
                if acts.get("flush"):
                    # Cache loss only costs future misses.
                    self.allocator.drop_cached()
                for rid in acts.get("cancel", ()):
                    self._cancel_req.add(rid)
                poison_rids = set(acts.get("poison", ()))
                n_force = int(acts.get("preempt", 0))
                if n_force and sched.preemptive:
                    for _ in range(n_force):
                        victim = sched.pick_victim()
                        if victim is None:
                            break
                        yield from self._preempt_one(st, victim, now)

            # ---- arrivals, overload shedding, cancels, deadlines -------
            if st.drain_at is None:
                for req in sched.poll_arrivals(now):
                    self.metrics.counter("serve_sheds_total").inc()
                    yield self._retire_unadmitted(req, RequestStatus.SHED,
                                                  now)
            if self._cancel_req:
                cancels = self.metrics.counter("serve_cancels_total")
                for rid in sorted(self._cancel_req):
                    sr = next((s for s in sched.running.values()
                               if s.rid == rid), None)
                    if sr is not None:
                        cancels.inc()
                        yield self._retire_record(
                            st, sr, RequestStatus.CANCELLED, now)
                        continue
                    obj = sched.remove_queued(rid)
                    if isinstance(obj, Request):
                        cancels.inc()
                        yield self._retire_unadmitted(
                            obj, RequestStatus.CANCELLED, now)
                    elif obj is not None:
                        cancels.inc()
                        yield self._retire_record(
                            st, obj, RequestStatus.CANCELLED, now)
                self._cancel_req.clear()
            for sr in list(sched.running.values()) + list(sched.preempted):
                dl = sr.req.deadline_steps
                if dl is not None and now - sr.req.arrival_step >= dl:
                    self.metrics.counter("serve_timeouts_total").inc()
                    yield self._retire_record(
                        st, sr, RequestStatus.TIMEOUT, now)
            for req in [r for r in sched.arrived
                        if r.deadline_steps is not None
                        and now - r.arrival_step >= r.deadline_steps]:
                sched.arrived.remove(req)
                self.metrics.counter("serve_timeouts_total").inc()
                yield self._retire_unadmitted(req, RequestStatus.TIMEOUT,
                                              now)

            for r in sched.arrived:
                if r.rid not in eligible_wall:
                    eligible_wall[r.rid] = t_round
                    self.tracer.request_point(r.rid, "arrive", step=now)
            if self.defrag_interval:
                if n_loops % self.defrag_interval == 0:
                    tables = st.tables = self._maybe_defrag(sched, tables,
                                                            now)
            elif (self.defrag_threshold is not None
                  and self.allocator.hole_blocks >= self.defrag_min_holes
                  and self.allocator.fragmentation()
                  >= self.defrag_threshold):
                tables = st.tables = self._maybe_defrag(sched, tables, now)

            # ---- admission (fresh arrivals, recompute re-admissions and
            # page-out restores); frozen while draining.  Blocking prefill
            # runs here; chunked prefill dispatches nothing until the
            # segment ----
            pending_tok0: list[tuple[ScheduledRequest, torch.Tensor]] = []
            pf_wall = 0.0
            admits = [] if st.drain_at is not None else \
                sched.admit_ready(now)
            for sr in admits:
                row, req = sr.row, sr.req
                rids[row] = req.rid
                max_new[row] = req.max_new
                stops[row] = -1
                stops[row, :len(req.stop_tokens)] = req.stop_tokens
                tables[row] = kv_pool.NULL_BLOCK
                tables[row, :len(sr.blocks)] = sr.blocks
                streams.setdefault(req.rid, ([], []))
                had_cow = sr.cow_src >= 0
                if had_cow:
                    # Exact-hit copy-on-write: the scheduler mapped a fresh
                    # dst block into the shared tail slot and decref'd the
                    # src; copy the cached page now, ahead (in stream
                    # order) of any later prefill that could recycle src.
                    dst = sr.blocks[sr.pf_start // self.block_size]
                    self._cow_copy(sr.cow_src, dst, req.rid, now)
                    sr.cow_src = -1
                if self.prefix_cache and not sr.spilled:
                    if sr.shared_tokens > 0:
                        self.metrics.counter(
                            "serve_prefix_hits_total").inc()
                        self.metrics.counter(
                            "serve_prefix_hit_tokens_total").inc(
                                sr.pf_start)
                        self.tracer.request_point(
                            req.rid, "prefix_hit", step=now,
                            shared_tokens=sr.shared_tokens,
                            suffix_start=sr.pf_start)
                    else:
                        self.metrics.counter(
                            "serve_prefix_misses_total").inc()
                if sr.spilled:
                    # Page-out restore: scatter the spilled bytes into the
                    # fresh blocks, restore the host cursors (the pending
                    # token included) and rejoin decode, no prefill.
                    entry = self.spill.pop(req.rid)
                    t0r = self.tracer.now()
                    self.pages = kv_pool.insert_blocks(
                        self.pages, entry.kv, sr.blocks)
                    sr.spilled = False
                    sr.spill_blocks = 0
                    sr.state = State.DECODE
                    sr.ctx_len = entry.ctx_len
                    sr.n_out = entry.n_out
                    sr.pf_written = 0
                    n_out[row] = entry.n_out
                    lens[row] = entry.ctx_len
                    done[row] = False
                    tok[row] = entry.pending_tok
                    self.metrics.counter("serve_restores_total").inc()
                    self.tracer.span(
                        "spill_restore", t0r, self.tracer.now(),
                        cat="durability",
                        args={"step": now, "rid": req.rid,
                              "blocks": entry.n_blocks,
                              "bytes": entry.nbytes})
                    self.tracer.request_point(req.rid, "restore", step=now,
                                              row=row, n_out=sr.n_out)
                    # The restored bytes are the original prefill's: index
                    # the prompt blocks again for future sharers.
                    self._register_prefix(sr, entry.ctx_len)
                    yield {"event": "admit", "rid": req.rid, "step": now,
                           "recompute": False, "restored": True}
                    continue
                n_out[row] = sr.n_out
                if sr.n_preempt > 0:
                    self.metrics.counter("serve_recomputes_total").inc()
                else:
                    self.metrics.histogram(
                        "serve_queue_delay_steps").observe(
                            now - req.arrival_step)
                self.tracer.request_point(
                    req.rid, "resume" if sr.n_preempt > 0 else "admit",
                    step=now, row=row, blocks=len(sr.blocks))
                if chunked:
                    # The (possibly resumed) prompt streams into the pool
                    # chunk by chunk; the row idles in the decode loop
                    # (done) until its final chunk samples the pending
                    # token.  A prefix hit starts the chunk cursor past
                    # the shared blocks.
                    sr.pf_written = sr.pf_start
                    sr.ctx_len = sr.pf_start
                    sr.cow_skip = had_cow
                    lens[row] = 0
                    done[row] = True
                    tok[row] = 0
                else:
                    lens[row] = sr.cur_prompt_len
                    done[row] = False
                    t0 = time.perf_counter()
                    ta = self.tracer.now()
                    pending_tok0.append(
                        (sr, self._admit(sr, plan, greedy, rng, temp,
                                         skip_write=had_cow)))
                    pf_wall += time.perf_counter() - t0
                    self.tracer.span(
                        "admit_prefill", ta, self.tracer.now(),
                        cat="prefill", args={"step": now, "rid": req.rid})
                    self._register_prefix(sr, sr.cur_prompt_len)
                yield {"event": "admit", "rid": req.rid, "step": now,
                       "recompute": sr.n_preempt > 0}
            if pending_tok0:
                # One device-to-host read for the whole admission round.
                t0 = time.perf_counter()
                ta = self.tracer.now()
                vals = torch.cat([t for _, t in pending_tok0]).cpu().numpy()
                self.metrics.counter("serve_host_syncs_total").inc()
                for (sr, _), v in zip(pending_tok0, vals):
                    tok[sr.row] = int(v)
                self.metrics.counter("serve_prefill_seconds_total").inc(
                    pf_wall + (time.perf_counter() - t0))
                self.tracer.span(
                    "admit_join", ta, self.tracer.now(), cat="prefill",
                    args={"step": now, "n_requests": len(pending_tok0)})
            self.metrics.gauge("serve_max_concurrency").set_max(
                len(sched.running))
            stats = self.allocator.stats()
            for gauge, stat in (("serve_pool_occupancy", "occupancy"),
                                ("serve_pool_fragmentation",
                                 "fragmentation"),
                                ("serve_pool_shared_blocks", "shared"),
                                ("serve_pool_owned_blocks", "owned"),
                                ("serve_pool_cached_blocks", "cached")):
                self.metrics.gauge(gauge).set(stats[stat])
            self.metrics.gauge("serve_running").set(len(sched.running))
            if self.telemetry.enabled:
                self.telemetry.occupancy_trace.append(
                    (now, stats["occupancy"]))
                self.telemetry.fragmentation_trace.append(
                    (now, stats["fragmentation"]))
                ts_round = self.tracer.now()
                self.tracer.counter(
                    "pool blocks", {k: stats[k] for k in (
                        "live", "free", "hidden", "shared", "cached")},
                    ts=ts_round)
                self.tracer.counter(
                    "requests", {"running": len(sched.running),
                                 "queued": sched.queue_len}, ts=ts_round)

            if not sched.running:
                if not sched.has_work:
                    break
                nxt = sched.next_arrival()
                if nxt is not None and nxt > now:
                    now = nxt
                    n_stalled = 0
                    continue
                # Admission blocked with nothing running (fault-hidden
                # blocks, a pathological max_queue): tick the clock so the
                # fault schedule advances; a bounded stall counter turns a
                # livelock into a loud failure.
                now += 1
                n_stalled += 1
                if n_stalled > 10_000:
                    raise RuntimeError(
                        "scheduler stalled: nothing running and the "
                        "admission head cannot be admitted "
                        f"(free={self.allocator.free_blocks}, "
                        f"hidden={self.allocator.hidden_blocks})")
                continue
            n_stalled = 0

            # ---- growth (oldest-first; may preempt newest-admitted) ----
            w_need = 1
            for sr in sorted(sched.running.values(),
                             key=lambda s: s.admit_seq):
                if sched.running.get(sr.row) is not sr:
                    continue
                target = None
                if chunked and sr.state is State.PREFILL:
                    cnt = min(chunk, sr.cur_prompt_len - sr.pf_written)
                    fin = sr.pf_written + cnt >= sr.cur_prompt_len
                    span = sr.pf_written + chunk
                    if fin:
                        span = max(span,
                                   sr.cur_prompt_len + self.segment_len)
                        target = sr.cur_prompt_len + self.segment_len
                else:
                    span = int(lens[sr.row]) + self.segment_len
                    target = sr.ctx_len + self.segment_len
                if target is not None:
                    new_blocks = yield from self._grow(st, sr, target, now)
                    if new_blocks is None:
                        continue
                    if new_blocks:
                        n_have = len(sr.blocks)
                        tables[sr.row,
                               n_have - len(new_blocks):n_have] = new_blocks
                if self.prefix_cache:
                    ws = (sr.pf_written
                          if chunked and sr.state is State.PREFILL
                          else int(lens[sr.row]))
                    yield from self._cow_writes(st, sr, ws, span, now,
                                                tables)
                    if sched.running.get(sr.row) is not sr:
                        continue
                w_need = max(w_need,
                             kv_pool.blocks_for(span, self.block_size))
            if not sched.running:
                continue

            pf_rows: list[tuple[int, ScheduledRequest, int, bool]] = []
            for row, sr in (sched.running.items() if chunked else ()):
                if sr.state is State.PREFILL:
                    cnt = min(chunk, sr.cur_prompt_len - sr.pf_written)
                    fin = sr.pf_written + cnt >= sr.cur_prompt_len
                    pf_rows.append((row, sr, cnt, fin))

            poison = np.zeros(mb, bool)
            for row, sr in sched.running.items():
                if sr.rid in poison_rids:
                    poison[row] = True
            poison_v = on_dev(poison)
            w = min(tables.shape[1], autotune.next_pow2(w_need))
            row_state = [on_dev(a) for a in (
                np.ascontiguousarray(tables[:, :w]), tok, n_out, lens, done,
                rids, max_new, stops)]
            t_seg = self.tracer.now()
            if pf_rows:
                pb = min(mb, autotune.next_pow2(len(pf_rows)))
                pf_set = {row for row, *_ in pf_rows}
                pad_row = next((r for r in range(mb) if r not in pf_set), 0)
                pf_idx = np.full(pb, pad_row, np.int64)
                pf_tok = np.zeros((pb, chunk), np.int64)
                pf_pos = np.zeros(pb, np.int32)
                pf_cnt = np.zeros(pb, np.int32)
                pf_on = np.zeros(pb, bool)
                pf_nw = np.zeros(pb, bool)
                pf_fin = np.zeros(pb, bool)
                pf_t0 = np.zeros(pb, np.int32)
                for i, (row, sr, cnt, fin) in enumerate(pf_rows):
                    start = sr.pf_written
                    pf_idx[i] = row
                    pf_tok[i, :cnt] = sr.cur_prompt[start:start + cnt]
                    pf_pos[i] = start
                    pf_cnt[i] = cnt
                    pf_on[i] = True
                    pf_nw[i] = sr.cow_skip
                    pf_fin[i] = fin
                    pf_t0[i] = sr.n_out
                pf_w_need = kv_pool.blocks_for(
                    int((pf_pos + pf_cnt).max()), self.block_size)
                pf_w = min(tables.shape[1],
                           autotune.next_pow2(max(pf_w_need, 1)))
                pf_tables = np.ascontiguousarray(tables[pf_idx, :pf_w])
                has_past = bool(pf_pos.max() > 0)
                mixed_fn = self._mixed_segment_fn(
                    plan, greedy, self.segment_len, has_past)
                seg_tables, *rest = row_state
                outs = self._dispatch(
                    mixed_fn, self.params, self.pages, seg_tables,
                    on_dev(pf_idx), on_dev(pf_tables), on_dev(pf_tok),
                    on_dev(pf_pos), on_dev(pf_cnt), on_dev(pf_on),
                    on_dev(pf_nw), on_dev(pf_fin), on_dev(pf_t0), *rest,
                    poison_v, rng, temp, pad, name="mixed_segment")
                self.metrics.counter("serve_prefill_chunks_total").inc(
                    len(pf_rows))
            else:
                outs = self._dispatch(
                    seg_fn, self.params, self.pages, *row_state, poison_v,
                    rng, temp, pad, name="decode_segment")
            (pages, tok_d, n_out_d, lens_d, done_d, failed_d, out_t,
             out_lp, i_exec) = outs
            self.pages = pages
            self.metrics.counter("serve_segments_total").inc()
            tok, n_out_new, lens, done, failed, out_t, out_lp = (
                a.cpu().numpy().copy() for a in (
                    tok_d, n_out_d, lens_d, done_d, failed_d, out_t,
                    out_lp))
            st.tok, st.n_out, st.lens, st.done = tok, n_out_new, lens, done
            self.metrics.counter("serve_host_syncs_total").inc()
            t_harvest = time.perf_counter()
            self.tracer.span(
                "segment", t_seg, self.tracer.now(),
                args={"step": now,
                      "index": self.metrics.value("serve_segments_total"),
                      "kind": "mixed" if pf_rows else "decode",
                      "rows_live": len(sched.running),
                      "rows_prefill": len(pf_rows),
                      "steps": int(i_exec), "table_width": int(w),
                      "occupancy": stats["occupancy"],
                      "fragmentation": stats["fragmentation"]})
            n_out = n_out_new
            for i, (row, sr, cnt, fin) in enumerate(pf_rows):
                sr.pf_written += cnt
                sr.ctx_len = sr.pf_written
                sr.cow_skip = False        # the write-skip covers one chunk
                self.tracer.request_point(
                    sr.rid, "prefill_chunk", step=now, n_tok=cnt,
                    written=sr.pf_written, final=fin)
                if fin and not failed[row]:
                    # Index the prompt blocks only once the whole prompt
                    # landed cleanly (a NaN final chunk must not publish
                    # pages future sharers would read).
                    self._register_prefix(sr, sr.pf_written)
                    if self.first_logits is not None:
                        self._keep_first_logits(
                            sr.rid, self._chunk_logits[i:i + 1])

            for row, sr in list(sched.running.items()):
                if chunked and sr.state is State.PREFILL \
                        and sr.pf_written < sr.cur_prompt_len:
                    continue
                cnt = int(n_out_new[row]) - sr.n_out
                if cnt > 0:
                    if sr.n_out == 0:
                        sr.first_token_step = now + 1
                        ttft = (t_harvest
                                - eligible_wall.get(sr.rid, t_harvest))
                        if sr.rid not in self.telemetry.ttft_seconds:
                            self.metrics.histogram(
                                "serve_ttft_seconds").observe(ttft)
                            self.tracer.request_point(
                                sr.rid, "first_token", step=now + 1,
                                ttft_s=ttft)
                        self.telemetry.ttft_seconds[sr.rid] = ttft
                    if sr.state is State.PREFILL:
                        sr.state = State.DECODE
                    streams[sr.rid][0].extend(
                        int(t) for t in out_t[row, :cnt])
                    streams[sr.rid][1].extend(
                        float(x) for x in out_lp[row, :cnt])
                    yield {"event": "tokens", "rid": sr.rid,
                           "step": now + cnt,
                           "tokens": list(out_t[row, :cnt]),
                           "logprobs": list(out_lp[row, :cnt])}
                sr.n_out = int(n_out_new[row])
                sr.ctx_len = int(lens[row])
                if failed[row]:
                    self.metrics.counter("serve_failed_total").inc()
                    yield self._retire_record(
                        st, sr, RequestStatus.FAILED, now + cnt)
                elif done[row]:
                    toks, lps = streams.pop(sr.rid)
                    reason = ("stop" if toks and
                              toks[-1] in sr.req.stop_tokens else "length")
                    sched.finish(sr, now + cnt)
                    tables[row] = kv_pool.NULL_BLOCK
                    lens[row] = 0
                    self.metrics.counter(
                        "serve_requests_total",
                        "Requests retired, by terminal status",
                        labels={"status": RequestStatus.OK.value}).inc()
                    self.metrics.histogram(
                        "serve_request_latency_steps").observe(
                            sr.finished_step - sr.req.arrival_step)
                    self.tracer.request_retire(
                        sr.rid, RequestStatus.OK.value,
                        step=sr.finished_step, n_tokens=len(toks),
                        finish_reason=reason)
                    result = RequestResult(
                        rid=sr.rid, tokens=np.asarray(toks, np.int32),
                        logprobs=np.asarray(lps, np.float32),
                        finish_reason=reason,
                        arrival_step=sr.req.arrival_step,
                        admitted_step=sr.admitted_step,
                        first_token_step=sr.first_token_step,
                        finished_step=sr.finished_step,
                        ttft_seconds=self.last_run_ttft_seconds.get(
                            sr.rid, float("nan")),
                        status=RequestStatus.OK,
                        n_preemptions=sr.n_preempt)
                    yield {"event": "finish", "rid": sr.rid,
                           "step": sr.finished_step, "result": result}
            now += int(i_exec)

    # ---------------------------------------------------------------- admit

    def _admit(self, sr: ScheduledRequest, plan, greedy, rng, temp,
               skip_write: bool = False):
        """Blocking-prefill admission: the bucketed prompt (a recompute
        re-admission's prompt plus its generated tokens) forward into a
        dense scratch cache of whole blocks, packed into the pool, and its
        first sample at step ``sr.n_out`` -- the (key, rid, step) triple
        the token had before any preemption.  A prefix-cache hit
        (``sr.pf_start > 0``) instead runs only the unique suffix through
        one B = 1 ``model.prefill_chunk`` over the mapped shared pages;
        ``skip_write`` (an exact-full-prompt hit, whose CoW copy already
        holds exact K/V for every suffix position) computes the logits
        from the in-flight K/V and masks the page writes.  Returns the
        device's first token ``[1]``; the caller joins one admission round
        with one read."""
        rid = torch.tensor([sr.req.rid], dtype=torch.int32,
                           device=self.device)
        sample = self.engine.make_sample(plan, greedy)
        if sr.pf_start > 0:
            s_len = sr.cur_prompt_len - sr.pf_start
            cw = autotune.next_pow2(
                kv_pool.blocks_for(s_len, self.block_size)) \
                * self.block_size
            tw_need = max(kv_pool.blocks_for(sr.cur_prompt_len,
                                             self.block_size),
                          len(sr.blocks))
            tw = min(self.max_blocks_per_req, autotune.next_pow2(tw_need))
            toks = np.zeros((1, cw), np.int64)
            toks[0, :s_len] = sr.cur_prompt[sr.pf_start:]
            table = np.zeros((1, tw), np.int32)
            table[0, :len(sr.blocks)] = sr.blocks

            def suffix(params, pages, tokens, pos, n_tok, block_table):
                logits0, pages = model_lib.prefill_chunk(
                    params, tokens, self.cfg, pages=pages,
                    block_tables=block_table, pos=pos, n_tok=n_tok,
                    write_mask=torch.tensor([not skip_write],
                                            device=self.device),
                    has_past=True, mode=plan)
                self._keep_first_logits(sr.rid, logits0)
                return sample(logits0, rng, rid, sr.n_out, temp), pages

            dev = self.device
            tok0, self.pages = self._dispatch(
                suffix, self.params, self.pages,
                torch.as_tensor(toks, device=dev),
                torch.tensor([sr.pf_start], dtype=torch.int32, device=dev),
                torch.tensor([s_len], dtype=torch.int32, device=dev),
                torch.as_tensor(table, device=dev), name="suffix_prefill")
            self.metrics.counter("serve_prefills_total").inc()
            self.metrics.counter("serve_suffix_prefills_total").inc()
            return tok0
        prompt = torch.as_tensor(np.asarray(sr.cur_prompt, np.int64),
                                 device=self.device)[None]
        batch = self.engine.bucket({"tokens": prompt})
        n_blocks = kv_pool.blocks_for(int(batch["tokens"].shape[1]),
                                      self.block_size)
        bt_pf = np.zeros(n_blocks, np.int32)
        bt_pf[:len(sr.blocks)] = sr.blocks

        def prefill(params, pages, block_table):
            logits, pages = model_lib.prefill_paged(
                params, batch, self.cfg, pages=pages,
                block_table=block_table,
                max_len=n_blocks * self.block_size, mode=plan)
            self._keep_first_logits(sr.rid, logits[:, -1])
            return sample(logits[:, -1], rng, rid, sr.n_out, temp), pages

        tok0, self.pages = self._dispatch(
            prefill, self.params, self.pages,
            torch.as_tensor(bt_pf, device=self.device), name="prefill")
        self.metrics.counter("serve_prefills_total").inc()
        return tok0

    def _keep_first_logits(self, rid: int, logits: torch.Tensor) -> None:
        if self.first_logits is not None:
            self.first_logits[rid] = logits[0].float().clone()

    def _register_prefix(self, sr: ScheduledRequest, covered: int) -> None:
        """Publish sr's fully written ORIGINAL-prompt blocks in the
        allocator's prefix index so later admissions can map them.  Caps
        at the original prompt: a recompute re-admission's regenerated
        suffix blocks hold this request's sampled history, not shareable
        prompt content.  Existing keys stay: first writer wins."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        n = min(int(covered), sr.req.prompt_len) // bs
        if n <= 0:
            return
        prompt = np.asarray(sr.req.prompt)
        for i, key in enumerate(kv_pool.prefix_keys(prompt[:n * bs], bs)):
            self.allocator.register_prefix(sr.blocks[i], key)


# Run stats as read-only views of the metrics registry.
_RUN_METRIC_ATTRS = {
    "last_run_segments": "serve_segments_total",
    "last_run_prefills": "serve_prefills_total",
    "last_run_prefill_chunks": "serve_prefill_chunks_total",
    "last_run_dispatches": "serve_dispatches_total",
    "last_run_host_syncs": "serve_host_syncs_total",
    "last_run_defrags": "serve_defrags_total",
    "last_run_preemptions": "serve_preemptions_total",
    "last_run_recomputes": "serve_recomputes_total",
    "last_run_spills": "serve_spills_total",
    "last_run_spill_bytes": "serve_spill_bytes_total",
    "last_run_restores": "serve_restores_total",
    "last_run_snapshots": "serve_snapshots_total",
    "last_run_recoveries": "serve_recoveries_total",
    "last_run_sheds": "serve_sheds_total",
    "last_run_timeouts": "serve_timeouts_total",
    "last_run_cancels": "serve_cancels_total",
    "last_run_failed": "serve_failed_total",
    "last_run_max_concurrency": "serve_max_concurrency",
    "last_run_prefill_seconds": "serve_prefill_seconds_total",
    "last_run_prefix_hits": "serve_prefix_hits_total",
    "last_run_prefix_misses": "serve_prefix_misses_total",
    "last_run_prefix_hit_tokens": "serve_prefix_hit_tokens_total",
    "last_run_cow_copies": "serve_cow_copies_total",
    "last_run_suffix_prefills": "serve_suffix_prefills_total",
}


def _run_metric_property(metric: str) -> property:
    def read(self):
        return self.metrics.value(metric)
    read.__doc__ = f"Run stat: reads the {metric!r} registry value."
    return property(read)


for _attr, _metric in _RUN_METRIC_ATTRS.items():
    setattr(ContinuousEngine, _attr, _run_metric_property(_metric))
del _attr, _metric
