"""Port parity of fault injection (``serve/faults.py``) against the JAX
package's ContinuousEngine, with what ``tests/test_serve_faults.py``
asserts: preemption storms, NaN quarantine, cancels, deadlines, load
shedding, hidden pool blocks and seeded random chaos, all through the
real scheduler, allocator and sampler.  After every run the pool is
exactly full; OK requests equal their fault-free ``Engine.generate``
streams, interrupted ones are exact prefixes of them; and the port's
results equal the JAX engine's under the same fault schedule."""
import numpy as np
import pytest
import torch

from repro_torch.serve import RequestStatus
from test_torch_serve import (JRequest, TRequest, _assert_same,  # noqa: F401
                              _engine_pair, _serve_pair, master)

SEED = 7
SMALL = dict(block_size=4, max_blocks_per_req=8, segment_len=4,
             seq_bucket=8)


def _specs(vocab, *, n=3, prompt_len=4, max_new=12, arrivals=None, seed=0,
           deadline=None):
    rng = np.random.default_rng(seed)
    arrivals = arrivals if arrivals is not None else [0] * n
    return [dict(rid=10 + i, prompt=rng.integers(0, vocab, prompt_len),
                 max_new=max_new, arrival_step=int(arrivals[i]),
                 deadline_steps=deadline)
            for i in range(n)]


def _reference(te, spec, *, temperature=0.0, seed=None):
    """The request alone through the port's static engine with the same
    cache geometry: the fault-free stream outcomes are judged against."""
    key = None if seed is None else np.array([0, seed], np.uint32)
    ref = te.engine.generate(
        {"tokens": torch.as_tensor(np.asarray(spec["prompt"])[None])},
        max_new_tokens=spec["max_new"], temperature=temperature, key=key,
        request_ids=[spec["rid"]])
    return np.asarray(ref.tokens)[0]


def _assert_prefix(got, full):
    got = np.asarray(got)
    assert len(got) <= len(full)
    np.testing.assert_array_equal(got, full[:len(got)])


def _assert_drained(ce):
    assert ce.allocator.live_blocks == 0
    assert ce.allocator.hidden_blocks == 0
    assert ce.allocator.free_blocks == ce.allocator.capacity
    ce.allocator.check_invariants()


@pytest.mark.parametrize("temperature,int8", [(0.0, False), (0.8, False),
                                              (0.0, True)])
def test_preemption_storm_bit_identical(master, temperature, int8):
    """A pool far below the aggregate worst case forces growth-failure
    preemptions of decoding requests; every request completes OK with its
    isolated stream, as in the JAX engine."""
    je, te, cfg = _engine_pair(master, int8, max_batch=3, kv_blocks=9,
                               **SMALL)
    specs = _specs(cfg.vocab, n=4)
    seed = None if temperature == 0 else SEED
    preempts = []
    jr, res = _serve_pair(je, te, specs, seed=seed, temperature=temperature)
    for ev in te.tracer.to_chrome()["traceEvents"]:
        if ev["name"] == "preempt":
            preempts.append(ev)
    _assert_same(res, jr)
    assert te.last_run_preemptions >= 2
    assert te.last_run_recomputes >= 2
    assert te.last_run_preemptions == je.last_run_preemptions
    assert sum(1 for ev in preempts if ev["args"]["n_out"] > 0) >= \
        (1 if int8 else 2)
    for s in specs:
        got = res[s["rid"]]
        assert got.status is RequestStatus.OK
        np.testing.assert_array_equal(
            got.tokens, _reference(te, s, temperature=temperature,
                                   seed=seed))
    assert any(res[s["rid"]].n_preemptions > 0 for s in specs)
    _assert_drained(te)


@pytest.mark.parametrize("int8", [False, True])
def test_preemption_storm_chunked_prefill(master, int8):
    """Recompute re-admission composes with chunked prefill."""
    je, te, cfg = _engine_pair(master, int8, max_batch=3, kv_blocks=9,
                               chunked_prefill=True, prefill_chunk=4,
                               **SMALL)
    specs = _specs(cfg.vocab, n=4)
    jr, res = _serve_pair(je, te, specs)
    _assert_same(res, jr)
    assert te.last_run_preemptions >= 1
    for s in specs:
        assert res[s["rid"]].status is RequestStatus.OK
        np.testing.assert_array_equal(res[s["rid"]].tokens,
                                      _reference(te, s))
    _assert_drained(te)


def test_forced_preemption_storm_and_preempted_drop(master):
    """A forced storm with max_queue=1: the first victim requeues and
    recomputes to an OK finish; the second finds the queue full of
    preempted peers and retires as PREEMPTED with a clean prefix."""
    je, te, cfg = _engine_pair(master, max_batch=2, kv_blocks=32,
                               max_queue=1, **SMALL)
    specs = _specs(cfg.vocab, n=2, arrivals=(0, 1))
    fis = []

    def faults(cls):
        fis.append(cls.scripted({2: {"preempt": 2}}))
        return fis[-1]

    jr, res = _serve_pair(je, te, specs, faults=faults)
    _assert_same(res, jr)
    assert te.last_run_preemptions == 2
    assert fis[1].log and fis[1].log[0][0] == 2
    assert fis[1].log == fis[0].log
    assert {r.status for r in res.values()} == {RequestStatus.OK,
                                                 RequestStatus.PREEMPTED}
    for s in specs:
        got, ref = res[s["rid"]], _reference(te, s)
        if got.status is RequestStatus.OK:
            np.testing.assert_array_equal(got.tokens, ref)
            assert got.n_preemptions == 1
            assert got.finish_reason == "length"
        else:
            assert 0 < len(got.tokens) < len(ref)
            _assert_prefix(got.tokens, ref)
            assert got.finish_reason == "preempted"
    _assert_drained(te)


def test_nan_logits_quarantine_failed_row(master):
    """A poisoned row retires as FAILED with its clean prefix; its batch
    neighbour never sees the NaN."""
    je, te, cfg = _engine_pair(master, max_batch=2, kv_blocks=32, **SMALL)
    specs = _specs(cfg.vocab, n=2)
    bad = specs[0]
    jr, res = _serve_pair(
        je, te, specs,
        faults=lambda fi: fi.scripted({1: {"poison": [bad["rid"]]}}))
    _assert_same(res, jr)
    assert te.last_run_failed == 1
    got = res[bad["rid"]]
    assert got.status is RequestStatus.FAILED
    assert got.finish_reason == "failed"
    assert len(got.tokens) == 4
    _assert_prefix(got.tokens, _reference(te, bad))
    ok = res[specs[1]["rid"]]
    assert ok.status is RequestStatus.OK
    np.testing.assert_array_equal(ok.tokens, _reference(te, specs[1]))
    _assert_drained(te)


def test_nan_logits_quarantine_chunked_first_token(master):
    """Poison on the final prefill chunk quarantines the request before
    it ever joins decode."""
    je, te, cfg = _engine_pair(master, max_batch=2, kv_blocks=32,
                               chunked_prefill=True, prefill_chunk=4,
                               **SMALL)
    specs = _specs(cfg.vocab, n=2)
    bad = specs[1]
    jr, res = _serve_pair(
        je, te, specs,
        faults=lambda fi: fi.scripted({0: {"poison": [bad["rid"]]}}))
    _assert_same(res, jr)
    assert res[bad["rid"]].status is RequestStatus.FAILED
    assert len(res[bad["rid"]].tokens) == 0
    ok = res[specs[0]["rid"]]
    assert ok.status is RequestStatus.OK
    np.testing.assert_array_equal(ok.tokens, _reference(te, specs[0]))
    _assert_drained(te)


def test_cancel_mid_run_and_while_queued(master):
    """cancel() mid-stream retires a running request with its partial
    prefix at the next boundary; a queued rid retires before admission."""
    je, te, cfg = _engine_pair(master, max_batch=2, kv_blocks=32, **SMALL)
    specs = _specs(cfg.vocab, n=3, arrivals=(0, 0, 30))
    out = {}
    for name, eng, req_cls in (("jax", je, JRequest), ("port", te,
                                                       TRequest)):
        results = {}
        for ev in eng.run_stream([req_cls(**s) for s in specs]):
            if ev["event"] == "admit" and specs[2]["rid"] not in results:
                eng.cancel(specs[2]["rid"])
                results[specs[2]["rid"]] = None
            if ev["event"] == "tokens" and ev["rid"] == specs[0]["rid"] \
                    and specs[0]["rid"] not in results:
                eng.cancel(specs[0]["rid"])
                results[specs[0]["rid"]] = None
            if ev["event"] == "finish":
                results[ev["rid"]] = ev["result"]
        out[name] = results
    results = out["port"]
    _assert_same(results, out["jax"])
    assert te.last_run_cancels == 2
    r0 = results[specs[0]["rid"]]
    assert r0.status is RequestStatus.CANCELLED
    assert 0 < len(r0.tokens) < specs[0]["max_new"]
    _assert_prefix(r0.tokens, _reference(te, specs[0]))
    r2 = results[specs[2]["rid"]]
    assert r2.status is RequestStatus.CANCELLED
    assert len(r2.tokens) == 0 and r2.admitted_step == -1
    r1 = results[specs[1]["rid"]]
    assert r1.status is RequestStatus.OK
    np.testing.assert_array_equal(r1.tokens, _reference(te, specs[1]))
    _assert_drained(te)


def test_deadline_timeout_running_and_queued(master):
    """deadline_steps retires a running request with its partial prefix
    and a still-queued one with nothing, both as TIMEOUT."""
    je, te, cfg = _engine_pair(master, max_batch=1, kv_blocks=32, **SMALL)
    slow = _specs(cfg.vocab, n=1, max_new=20, deadline=6)[0]
    queued = dict(_specs(cfg.vocab, n=1, seed=1)[0], rid=99,
                  deadline_steps=4)
    jr, res = _serve_pair(je, te, [slow, queued])
    _assert_same(res, jr)
    assert te.last_run_timeouts == 2
    got = res[slow["rid"]]
    assert got.status is RequestStatus.TIMEOUT
    assert 0 < len(got.tokens) < slow["max_new"]
    _assert_prefix(got.tokens, _reference(te, slow))
    q = res[queued["rid"]]
    assert q.status is RequestStatus.TIMEOUT
    assert len(q.tokens) == 0 and q.admitted_step == -1
    _assert_drained(te)


def test_bounded_queue_load_shedding(master):
    """max_queue bounds the admission queue: a burst beyond it is
    tail-shed while the head of the line completes untouched."""
    je, te, cfg = _engine_pair(master, max_batch=1, kv_blocks=32,
                               max_queue=1, **SMALL)
    specs = _specs(cfg.vocab, n=4, max_new=6)
    jr, res = _serve_pair(je, te, specs)
    _assert_same(res, jr)
    assert te.last_run_sheds == 3
    statuses = [res[s["rid"]].status for s in specs]
    assert statuses == [RequestStatus.OK] + [RequestStatus.SHED] * 3
    np.testing.assert_array_equal(res[specs[0]["rid"]].tokens,
                                  _reference(te, specs[0]))
    for s in specs[1:]:
        assert len(res[s["rid"]].tokens) == 0
        assert res[s["rid"]].finish_reason == "shed"
    _assert_drained(te)


def test_hidden_blocks_force_preemption_then_drain(master):
    """Hiding free blocks mid-run forces growth failures through the real
    allocator; once released, the run drains to full completion."""
    je, te, cfg = _engine_pair(master, max_batch=2, kv_blocks=13, **SMALL)
    specs = _specs(cfg.vocab, n=2)
    jr, res = _serve_pair(
        je, te, specs,
        faults=lambda fi: fi.scripted({1: {"hide": 8},
                                       4: {"unhide": True}}))
    _assert_same(res, jr)
    assert te.last_run_preemptions >= 1
    for s in specs:
        assert res[s["rid"]].status is RequestStatus.OK
        np.testing.assert_array_equal(res[s["rid"]].tokens,
                                      _reference(te, s))
    _assert_drained(te)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_chaos_survivors_bit_identical(master, seed):
    """Seeded probabilistic chaos over a small pool: OK requests equal
    their fault-free streams, interrupted ones are clean prefixes, the
    same seed injects the same schedule, and the JAX engine under that
    schedule ends every request the same way."""
    kw = dict(max_batch=3, kv_blocks=13, **SMALL)
    je, te, cfg = _engine_pair(master, **kw)
    specs = _specs(cfg.vocab, n=6, max_new=8, arrivals=(0, 0, 2, 4, 6, 8))
    fis = []

    def faults(cls):
        fis.append(cls(seed=seed, hide_prob=0.25, hide_max=4,
                       preempt_prob=0.2, poison_prob=0.1, cancel_prob=0.1,
                       stop_round=25))
        return fis[-1]

    jr, res = _serve_pair(je, te, specs, faults=faults)
    _assert_same(res, jr)
    assert fis[1].log == fis[0].log
    for s in specs:
        got, ref = res[s["rid"]], _reference(te, s)
        if got.status is RequestStatus.OK:
            np.testing.assert_array_equal(got.tokens, ref)
        else:
            _assert_prefix(got.tokens, ref)
    sched_a = list(fis[1].log)
    fis[1].reset()
    _, te2, _ = _engine_pair(master, **kw)
    res2 = te2.run([TRequest(**s) for s in specs], faults=fis[1])
    assert list(fis[1].log) == sched_a
    for s in specs:
        assert res2[s["rid"]].status is res[s["rid"]].status
        np.testing.assert_array_equal(res2[s["rid"]].tokens,
                                      res[s["rid"]].tokens)
    _assert_drained(te)
    _assert_drained(te2)
