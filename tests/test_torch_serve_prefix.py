"""Port parity of the prefix-cached KV pool against the JAX package's
ContinuousEngine, with what ``tests/test_serve_prefix.py`` asserts: token
streams identical to the uncached engine across fp/int8 x greedy/sampled
x chunked/blocking, cached-free revival, cache flushes and preemption
with sharing live, snapshot/restore with shared blocks, priority classes,
and refcount-aware pool hygiene after every run.  Every cached run is
also held against the JAX engine's on the same requests: tokens,
statuses and the cache counters.  The exact-hit copy-on-write cases are
in ``test_torch_serve_cow.py``."""
import numpy as np
import pytest

from repro_torch.serve import (PRIORITY_BATCH, PRIORITY_INTERACTIVE,
                               CrashPoint, FaultInjector, RequestStatus,
                               Scheduler, kv_pool)
from repro_torch.serve import Request as TRequest
from test_torch_serve import (_assert_same, _engine_pair,  # noqa: F401
                              _serve_pair, master)

SEED = 7
COUNTERS = ("prefix_hits", "prefix_hit_tokens", "prefix_misses",
            "cow_copies", "suffix_prefills", "preemptions")


def _pair_mk(master, int8=False, *, prefix=True, chunked=False, **kw):
    """Both engines at the JAX test's settings (the float ``exact`` plan:
    under W8A8 an int8 pool's suffix prefill, which reads the shared
    prefix as dequantized codes, can flip tokens against a full
    prefill in either package)."""
    kw.setdefault("max_batch", 3)
    kw.setdefault("kv_blocks", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_blocks_per_req", 8)
    kw.setdefault("segment_len", 4)
    kw.setdefault("seq_bucket", 8)
    kw.setdefault("preemption", "recompute")
    if chunked:
        kw.setdefault("chunked_prefill", True)
        kw.setdefault("prefill_chunk", 4)
    return _engine_pair(master, int8, "exact", None, prefix_cache=prefix,
                        debug_invariants=True, **kw)


def _shared_specs(vocab, *, seed=0, n=5, sys_blocks=2, bs=4):
    """Requests sharing a block-aligned system prefix (distinct tails)."""
    rng = np.random.default_rng(seed)
    sys = rng.integers(0, vocab, sys_blocks * bs)
    arrivals = (0, 0, 2, 4, 6)
    return [dict(rid=30 + i,
                 prompt=np.concatenate(
                     [sys, rng.integers(0, vocab, int(rng.integers(1, 6)))]),
                 max_new=5 + (i % 3),
                 arrival_step=arrivals[i % len(arrivals)])
            for i in range(n)]


def _tokens_equal(res, ref):
    assert set(res) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(res[rid].tokens, ref[rid].tokens,
                                      err_msg=f"rid {rid} tokens diverged")


def _same_counters(te, je):
    assert {c: getattr(te, f"last_run_{c}") for c in COUNTERS} == \
        {c: getattr(je, f"last_run_{c}") for c in COUNTERS}


def _assert_drained(ce):
    """Refcount-aware pool hygiene: no live pages, no dangling refs (the
    prefix index may keep cached-free entries, bytes intact)."""
    assert ce.allocator.live_blocks == 0
    assert ce.allocator.total_refs == 0
    assert ce.allocator.free_blocks == ce.allocator.capacity
    ce.allocator.check_invariants()


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_prefix_cached_bit_identical_and_hits(master, int8, chunked):
    """With a shared system prefix across the stream the prefix-cached
    engine emits exactly the uncached engine's tokens, greedy and sampled,
    while hitting the cache as often as the JAX engine does."""
    _, base, cfg = _pair_mk(master, int8, prefix=False, chunked=chunked)
    je, te, _ = _pair_mk(master, int8, chunked=chunked)
    specs = _shared_specs(cfg.vocab)
    reqs = [TRequest(**s) for s in specs]
    for i, temperature in enumerate((0.0, 0.8)):
        key = np.array([0, SEED], np.uint32)
        ref = base.run(reqs, key=key, temperature=temperature)
        jr, res = _serve_pair(je, te, specs, seed=SEED,
                              temperature=temperature)
        assert te.last_run_prefix_hits >= 2
        assert te.last_run_prefix_hit_tokens >= 2 * 8
        if i == 0:
            assert te.last_run_prefix_misses >= 1   # first writer missed
        _tokens_equal(res, ref)
        tol = 1e-2 if int8 else 1e-4
        for rid in ref:
            np.testing.assert_allclose(res[rid].logprobs, ref[rid].logprobs,
                                       rtol=tol, atol=tol)
        _assert_same(res, jr, logprobs=tol)
        _same_counters(te, je)
        if not chunked:
            assert te.last_run_suffix_prefills == te.last_run_prefix_hits
        _assert_drained(te)


def test_sequential_reuse_revives_cached_free_blocks(master):
    """A prefix stays matchable after its last owner retires: a later
    identical-prefix arrival revives the cached-free blocks."""
    rng = np.random.default_rng(5)
    _, base, cfg = _pair_mk(master, prefix=False)
    sys = rng.integers(0, cfg.vocab, 8)
    specs = [
        dict(rid=50, prompt=np.concatenate(
            [sys, rng.integers(0, cfg.vocab, 3)]), max_new=4,
            arrival_step=0),
        dict(rid=51, prompt=np.concatenate(
            [sys, rng.integers(0, cfg.vocab, 4)]), max_new=5,
            arrival_step=40)]                    # long after rid 50 retired
    ref = base.run([TRequest(**s) for s in specs])
    je, te, _ = _pair_mk(master)
    jr, res = _serve_pair(je, te, specs)
    assert te.last_run_prefix_hits == 1
    assert te.last_run_prefix_hit_tokens == 8
    _tokens_equal(res, ref)
    _assert_same(res, jr)
    _same_counters(te, je)
    _assert_drained(te)


def test_cache_flush_fault_only_costs_misses(master):
    """The {'flush': True} chaos action drops every cached-free entry
    mid-run; that costs hit rate, never correctness."""
    _, base, cfg = _pair_mk(master, prefix=False)
    specs = _shared_specs(cfg.vocab, seed=9)
    ref = base.run([TRequest(**s) for s in specs])
    je, te, _ = _pair_mk(master)
    jr, res = _serve_pair(
        je, te, specs,
        faults=lambda fi: fi.scripted({1: {"flush": True},
                                       3: {"flush": True}}))
    _tokens_equal(res, ref)
    _assert_same(res, jr)
    _same_counters(te, je)
    _assert_drained(te)
    names = {e["name"] for e in te.tracer.to_chrome()["traceEvents"]}
    assert "fault:flush" in names


def test_preempt_storm_with_sharing_bit_identity(master):
    """Forced preemptions while blocks are shared: recompute re-admission
    goes back through prefix matching, and every request still ends with
    the uncached, unfaulted engine's tokens."""
    _, base, cfg = _pair_mk(master, prefix=False)
    specs = _shared_specs(cfg.vocab, seed=11)
    ref = base.run([TRequest(**s) for s in specs])
    je, te, _ = _pair_mk(master)
    jr, res = _serve_pair(
        je, te, specs,
        faults=lambda fi: fi.scripted({2: {"preempt": 1},
                                       4: {"preempt": 2}}))
    assert te.last_run_preemptions >= 1
    assert all(r.status is RequestStatus.OK for r in res.values())
    _tokens_equal(res, ref)
    _assert_same(res, jr)
    _same_counters(te, je)
    _assert_drained(te)


def test_crash_restore_with_shared_blocks(master, tmp_path):
    """Snapshot/restore while shared blocks are live: refcounts and the
    prefix index ride the snapshot, the restored engine still shows the
    sharing, and the resumed run completes bit-identically."""
    rng = np.random.default_rng(13)
    _, ref_eng, cfg = _pair_mk(master, preemption="page_out")
    sys = rng.integers(0, cfg.vocab, 8)
    specs = [dict(rid=60 + i, prompt=np.concatenate(
                [sys, rng.integers(0, cfg.vocab, 2 + i)]),
                max_new=14, arrival_step=3 * i) for i in range(3)]
    reqs = [TRequest(**s) for s in specs]
    ref = ref_eng.run(reqs)
    snap = dict(preemption="page_out", snapshot_dir=str(tmp_path),
                snapshot_interval=1)
    _, ce, _ = _pair_mk(master, **snap)
    crashed = {}
    with pytest.raises(CrashPoint):
        for ev in ce.run_stream(reqs, faults=FaultInjector.crash_at(4)):
            if ev["event"] == "finish":
                crashed[ev["rid"]] = ev["result"]
    assert ce.last_snapshot_path is not None
    _, ce2, _ = _pair_mk(master, **snap)
    ce2.restore(ce.last_snapshot_path)
    assert ce2.allocator.shared_blocks >= 1      # sharing survived the trip
    assert ce2.allocator.total_refs > ce2.allocator.live_blocks
    resumed = ce2.resume()
    _tokens_equal({**crashed, **resumed}, ref)
    _assert_drained(ce2)


# ---------------------------------------------------------------------------
# Priority classes
# ---------------------------------------------------------------------------

def _req(rid, prompt_len, max_new, *, arrival=0, priority=0, deadline=None):
    return TRequest(rid=rid, prompt=np.zeros(prompt_len, np.int32),
                    max_new=max_new, arrival_step=arrival,
                    priority=priority, deadline_steps=deadline)


def test_priority_admission_order_and_edf_within_class():
    """Interactive requests jump the batch queue; within an elevated
    class the earlier deadline wins; the default class stays FCFS."""
    alloc = kv_pool.BlockAllocator(17)
    sched = Scheduler(alloc, max_batch=4, block_size=4, preemptive=True,
                      prefix_cache=True, debug=True)
    sched.submit(_req(0, 4, 4, deadline=3))
    sched.submit(_req(1, 4, 4))
    sched.submit(_req(2, 4, 4, priority=PRIORITY_INTERACTIVE, deadline=20))
    sched.submit(_req(3, 4, 4, priority=PRIORITY_INTERACTIVE, deadline=5))
    sched.poll_arrivals(0)
    admitted = sched.admit_ready(0)
    assert [sr.rid for sr in admitted] == [3, 2, 0, 1]
    for sr in admitted:
        sched.finish(sr, now=5)
    assert alloc.free_blocks == alloc.capacity


def test_pick_victim_is_lowest_priority_newest():
    alloc = kv_pool.BlockAllocator(17)
    sched = Scheduler(alloc, max_batch=4, block_size=4, preemptive=True,
                      debug=True)
    sched.submit(_req(0, 4, 8))
    sched.submit(_req(1, 4, 8))
    sched.submit(_req(2, 4, 8, priority=PRIORITY_INTERACTIVE))
    sched.poll_arrivals(0)
    by_rid = {sr.rid: sr for sr in sched.admit_ready(0)}
    assert sched.pick_victim() is by_rid[1]                 # batch, newest
    assert sched.pick_victim(exclude_rid=1) is by_rid[0]
    for sr in by_rid.values():
        sched.finish(sr, now=5)


def test_priority_eviction_e2e(master):
    """Pool-pressure preemption in a real run evicts the newest BATCH
    request, never the interactive one, and everyone completes OK, with
    JAX's streams and preemption counts."""
    _, _, cfg = _pair_mk(master, prefix=False)
    rng = np.random.default_rng(17)
    specs = [dict(rid=70 + i, prompt=rng.integers(0, cfg.vocab, 8),
                  max_new=10 if i < 2 else 3, arrival_step=0,
                  priority=PRIORITY_BATCH if i < 2 else PRIORITY_INTERACTIVE)
             for i in range(3)]
    je, te, _ = _pair_mk(master, kv_blocks=8, max_batch=3)
    jr, res = _serve_pair(je, te, specs)
    assert te.last_run_preemptions >= 1
    assert all(r.status is RequestStatus.OK for r in res.values())
    assert res[72].n_preemptions == 0            # interactive never evicted
    assert res[70].n_preemptions + res[71].n_preemptions \
        == te.last_run_preemptions
    _assert_same(res, jr)
    assert {r: res[r].n_preemptions for r in res} == \
        {r: jr[r].n_preemptions for r in jr}
    _assert_drained(te)


def test_prefix_cache_requires_preemptive_mode():
    with pytest.raises(ValueError):
        Scheduler(kv_pool.BlockAllocator(8), max_batch=2, block_size=4,
                  preemptive=False, prefix_cache=True)


def test_keep_first_logits(master):
    """``keep_first_logits`` keeps, per request, the logits its blocking
    admission sampled the first token from: greedy's first token is their
    argmax, and a prefix hit's suffix prefill gives the full prefill's
    logits (the float plan, an fp pool) within float reordering."""
    from repro_torch.serve import ContinuousEngine
    from test_torch_serve import _pair
    _, tc, _, tplan, _, tp = _pair(master, "exact", False)
    specs = _shared_specs(tc.vocab)
    kept = {}
    for prefix in (False, True):
        te = ContinuousEngine(
            tp, tc, plan=tplan, device="cpu", max_batch=3, kv_blocks=32,
            block_size=4, max_blocks_per_req=8, segment_len=4,
            seq_bucket=8, prefix_cache=prefix, keep_first_logits=True)
        res = te.run([TRequest(**s) for s in specs])
        assert set(te.first_logits) == set(res)
        for rid, r in res.items():
            assert r.status is RequestStatus.OK
            assert int(te.first_logits[rid].argmax()) == int(r.tokens[0])
        kept[prefix] = te.first_logits
        if prefix:
            assert te.last_run_suffix_prefills >= 1
    for rid, lg in kept[False].items():
        np.testing.assert_allclose(kept[True][rid].numpy(), lg.numpy(),
                                   rtol=1e-4, atol=1e-4)
