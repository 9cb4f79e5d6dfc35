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
* **Lifecycle** -- deadlines, :meth:`ContinuousEngine.cancel`, a bounded
  queue (``max_queue``) and the non-finite-logits guard retire requests as
  TIMEOUT / CANCELLED / SHED / FAILED with all blocks returned.
* **Seeded sampling** -- ``run(key=..., temperature=...)`` samples each
  row with ``fold_in(fold_in(key, rid), step)`` (``serve/prng.py``), so a
  request's stream is independent of its batch neighbours and equal to
  the JAX engine's at the same key.

Idle and finished rows still occupy compute lanes within a segment; their
page writes are masked to the null block and their outputs discarded.
Each segment hands the device only the pow2-bucketed live-width prefix of
the block tables, and the engine defrags adaptively so tables stay
contiguous.

Not ported yet (they raise ``NotImplementedError``): page-out
preemption, the prefix cache, snapshot/restore/drain and fault
injection.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backend as backend_lib
from repro_torch.kernels import autotune
from repro_torch.models import model as model_lib
from repro_torch.serve import kv_pool, prng
from repro_torch.serve import telemetry as telemetry_lib
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import (Request, RequestStatus,
                                         ScheduledRequest, Scheduler, State)

_LATER = "is not ported yet (ROADMAP queue 1, ContinuousEngine modes)"


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
    """Everything one serve run owns besides the device pages."""
    sched: Scheduler
    greedy: bool
    rng: torch.Tensor             # the run's sampler key (serve/prng.py)
    temperature: float
    tok: np.ndarray               # [mb] pending (sampled, unemitted) token
    n_out: np.ndarray             # [mb] emitted counts (post-harvest)
    lens: np.ndarray              # [mb] cache positions written
    done: np.ndarray              # [mb] idle/finished row mask
    rids: np.ndarray              # [mb]
    max_new: np.ndarray           # [mb]
    stops: np.ndarray             # [mb, stop_w]
    tables: np.ndarray            # [mb, max_blocks_per_req]
    streams: dict[int, tuple[list, list]]


class ContinuousEngine:
    """Continuous-batching engine over a paged KV pool of ``kv_blocks``
    blocks of ``block_size`` tokens on ``device`` (dense-attention archs;
    the int8 pool follows ``cfg.kv_cache_dtype``)."""

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
                 device="cuda"):
        if cfg.arch_type != "dense" or cfg.sliding_window is not None \
                or cfg.mrope_sections is not None:
            raise ValueError(
                "continuous batching serves dense-attention archs without "
                "sliding windows or M-RoPE")
        if preemption not in ("off", "recompute", "page_out"):
            raise ValueError("preemption must be 'off', 'recompute' or "
                             f"'page_out', got {preemption!r}")
        if preemption == "page_out":
            raise NotImplementedError(f"preemption='page_out' {_LATER}")
        if prefix_cache:
            raise NotImplementedError(f"prefix_cache {_LATER}")
        if snapshot_dir is not None or snapshot_interval is not None:
            raise NotImplementedError(f"snapshots {_LATER}")
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
        self.max_queue = max_queue
        self.debug_invariants = debug_invariants
        self._int8_pool = getattr(cfg, "kv_cache_dtype", "bf16") == "int8"
        if prefill_chunk is None:
            kvh = cfg.n_kv_heads
            prefill_chunk = autotune.choose_prefill_chunk(
                max_batch, kvh, block_size,
                torch.int8 if self._int8_pool else torch.float32,
                head_dim=cfg.resolved_head_dim, groups=cfg.n_heads // kvh)
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
        # The inner engine's max_len bounds blocking prefill's prompt
        # buckets, as in the JAX package.
        self.engine = Engine(params, cfg, max_len=self.max_seq_len,
                             plan=plan, seq_bucket=seq_bucket,
                             device=self.device)
        self.allocator = kv_pool.BlockAllocator(kv_blocks)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.pages = kv_pool.init_pages(cfg, kv_blocks, block_size, dtype,
                                        device=self.device)
        self._cancel_req: set[int] = set()
        if isinstance(telemetry, telemetry_lib.Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = telemetry_lib.Telemetry(
                enabled=True if telemetry is None else bool(telemetry),
                trace_samples=trace_samples,
                profiler_annotations=profiler_annotations)

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
                          "write_mask": ~done}
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
        current value back, a deterministic no-op."""
        cfg = self.cfg
        sample = self.engine.make_sample(plan, greedy)
        loop = self._decode_loop(self.engine.make_step(plan, greedy),
                                 seg_len)

        def seg(params, pages, tables, pf_rows, pf_tables, pf_tok, pf_pos,
                pf_cnt, pf_on, pf_fin, pf_t0, tok, n_out, lens, done, rids,
                max_new, stops, poison, rng, temperature, pad_token):
            logits0, pages = model_lib.prefill_chunk(
                params, pf_tok, cfg, pages=pages, block_tables=pf_tables,
                pos=pf_pos, n_tok=pf_cnt, write_mask=pf_on,
                has_past=has_past, mode=plan)
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
        'preempt' | 'finish' events as the sim advances."""
        if faults is not None:
            raise NotImplementedError(f"fault injection {_LATER}")
        requests = list(requests)
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("request ids must be unique within a run")
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
        self.telemetry.reset_run()
        sched = Scheduler(self.allocator, self.max_batch, self.block_size,
                          preemptive=self.preemption != "off",
                          prefix_cache=False, max_queue=self.max_queue,
                          debug=self.debug_invariants, metrics=self.metrics)
        for r in sorted(requests, key=lambda r: r.arrival_step):
            sched.submit(r)
        mb, nbr = self.max_batch, self.max_blocks_per_req
        st = _RunState(
            sched=sched, greedy=greedy, rng=rng,
            temperature=float(temperature), tok=np.zeros(mb, np.int32),
            n_out=np.zeros(mb, np.int32),
            lens=np.zeros(mb, np.int32), done=np.ones(mb, bool),
            rids=np.zeros(mb, np.int32), max_new=np.zeros(mb, np.int32),
            stops=np.full((mb, stop_w), -1, np.int32),
            tables=np.zeros((mb, nbr), np.int32), streams={})
        try:
            yield from self._serve_loop(st)
        finally:
            # An abandoned stream releases every in-flight request's
            # blocks so the allocator is exactly full for the next run.
            for sr in list(st.sched.running.values()):
                st.sched.finish(sr, -1)
            for sr in list(st.sched.preempted):
                st.sched.finish(sr, -1)

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
        """Evict one running request (recompute flavor): free its blocks,
        clear its row and requeue it.  fp pools re-prefill prompt +
        generated-so-far and re-sample the pending token; int8 pools
        restart from the original prompt (decode reads dequantized codes a
        stapled prefill could not reproduce)."""
        sched = st.sched
        row = victim.row
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
                                  n_out=victim.n_out, spilled=False)
        yield {"event": "preempt", "rid": victim.rid, "step": now,
               "n_out": victim.n_out, "spilled": False}
        if evicted is not None:
            self.metrics.counter("serve_sheds_total").inc()
            yield self._retire_unadmitted(evicted, RequestStatus.SHED, now)
        if not requeued:
            yield self._retire_record(st, victim, RequestStatus.PREEMPTED,
                                      now)
        elif self._int8_pool:
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

    # ------------------------------------------------------------ main loop

    def _serve_loop(self, st: _RunState) -> Iterator[dict]:
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
        tok, n_out, lens, done = st.tok, st.n_out, st.lens, st.done
        rids, max_new, stops, tables = (st.rids, st.max_new, st.stops,
                                        st.tables)
        streams = st.streams
        now = 0
        n_loops = 0
        n_stalled = 0
        chunk = self.prefill_chunk
        mb = tok.shape[0]
        eligible_wall: dict[int, float] = {}

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        while sched.has_work:
            n_loops += 1
            t_round = time.perf_counter()
            st.tok, st.n_out, st.lens, st.done = tok, n_out, lens, done
            st.tables = tables

            # ---- arrivals, overload shedding, cancels, deadlines -------
            for req in sched.poll_arrivals(now):
                self.metrics.counter("serve_sheds_total").inc()
                yield self._retire_unadmitted(req, RequestStatus.SHED, now)
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

            # ---- admission: blocking prefill runs here; chunked prefill
            # dispatches nothing until the segment ----
            pending_tok0: list[tuple[ScheduledRequest, torch.Tensor]] = []
            pf_wall = 0.0
            for sr in sched.admit_ready(now):
                row, req = sr.row, sr.req
                rids[row] = req.rid
                max_new[row] = req.max_new
                stops[row] = -1
                stops[row, :len(req.stop_tokens)] = req.stop_tokens
                tables[row] = kv_pool.NULL_BLOCK
                tables[row, :len(sr.blocks)] = sr.blocks
                streams.setdefault(req.rid, ([], []))
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
                    # token.
                    sr.pf_written = sr.pf_start
                    sr.ctx_len = sr.pf_start
                    lens[row] = 0
                    done[row] = True
                    tok[row] = 0
                else:
                    lens[row] = sr.cur_prompt_len
                    done[row] = False
                    t0 = time.perf_counter()
                    ta = self.tracer.now()
                    pending_tok0.append(
                        (sr, self._admit(sr, plan, greedy, rng, temp)))
                    pf_wall += time.perf_counter() - t0
                    self.tracer.span(
                        "admit_prefill", ta, self.tracer.now(),
                        cat="prefill", args={"step": now, "rid": req.rid})
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
            self.metrics.gauge("serve_pool_occupancy").set(
                stats["occupancy"])
            self.metrics.gauge("serve_pool_fragmentation").set(
                stats["fragmentation"])
            self.metrics.gauge("serve_running").set(len(sched.running))
            if self.telemetry.enabled:
                self.telemetry.occupancy_trace.append(
                    (now, stats["occupancy"]))
                self.telemetry.fragmentation_trace.append(
                    (now, stats["fragmentation"]))
                ts_round = self.tracer.now()
                self.tracer.counter(
                    "pool blocks", {"live": stats["live"],
                                    "free": stats["free"],
                                    "hidden": stats["hidden"]},
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
                now += 1
                n_stalled += 1
                if n_stalled > 10_000:
                    raise RuntimeError(
                        "scheduler stalled: nothing running and the "
                        "admission head cannot be admitted "
                        f"(free={self.allocator.free_blocks})")
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

            poison_v = on_dev(np.zeros(mb, bool))
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
                pf_fin = np.zeros(pb, bool)
                pf_t0 = np.zeros(pb, np.int32)
                for i, (row, sr, cnt, fin) in enumerate(pf_rows):
                    start = sr.pf_written
                    pf_idx[i] = row
                    pf_tok[i, :cnt] = sr.cur_prompt[start:start + cnt]
                    pf_pos[i] = start
                    pf_cnt[i] = cnt
                    pf_on[i] = True
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
                    on_dev(pf_fin), on_dev(pf_t0), *rest,
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
            for row, sr, cnt, fin in pf_rows:
                sr.pf_written += cnt
                sr.ctx_len = sr.pf_written
                self.tracer.request_point(
                    sr.rid, "prefill_chunk", step=now, n_tok=cnt,
                    written=sr.pf_written, final=fin)

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

    def _admit(self, sr: ScheduledRequest, plan, greedy, rng, temp):
        """Blocking-prefill admission: the bucketed prompt (a recompute
        re-admission's prompt plus its generated tokens) forward into a
        dense scratch cache of whole blocks, packed into the pool, and its
        first sample at step ``sr.n_out`` -- the (key, rid, step) triple
        the token had before any preemption.  Returns the device's first
        token ``[1]``; the caller joins one admission round with one
        read."""
        prompt = torch.as_tensor(np.asarray(sr.cur_prompt, np.int64),
                                 device=self.device)[None]
        batch = self.engine.bucket({"tokens": prompt})
        n_blocks = kv_pool.blocks_for(int(batch["tokens"].shape[1]),
                                      self.block_size)
        bt_pf = np.zeros(n_blocks, np.int32)
        bt_pf[:len(sr.blocks)] = sr.blocks
        sample = self.engine.make_sample(plan, greedy)

        def prefill(params, pages, block_table, rid):
            logits, pages = model_lib.prefill_paged(
                params, batch, self.cfg, pages=pages,
                block_table=block_table,
                max_len=n_blocks * self.block_size, mode=plan)
            return sample(logits[:, -1], rng, rid, sr.n_out, temp), pages

        tok0, self.pages = self._dispatch(
            prefill, self.params, self.pages,
            torch.as_tensor(bt_pf, device=self.device),
            torch.tensor([sr.req.rid], dtype=torch.int32,
                         device=self.device), name="prefill")
        self.metrics.counter("serve_prefills_total").inc()
        return tok0


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
    "last_run_sheds": "serve_sheds_total",
    "last_run_timeouts": "serve_timeouts_total",
    "last_run_cancels": "serve_cancels_total",
    "last_run_failed": "serve_failed_total",
    "last_run_max_concurrency": "serve_max_concurrency",
    "last_run_prefill_seconds": "serve_prefill_seconds_total",
}


def _run_metric_property(metric: str) -> property:
    def read(self):
        return self.metrics.value(metric)
    read.__doc__ = f"Run stat: reads the {metric!r} registry value."
    return property(read)


for _attr, _metric in _RUN_METRIC_ATTRS.items():
    setattr(ContinuousEngine, _attr, _run_metric_property(_metric))
del _attr, _metric
