"""Port parity of snapshot / restore / drain and crash recovery against
the JAX package, with what ``tests/test_serve_durability.py`` asserts:
a request that crosses a process death through a snapshot file finishes
with exactly the stream an uninterrupted run produces.  Also: a snapshot
the JAX engine writes restores in the port (and the port's in the JAX
engine) and finishes with JAX's tokens, the port's snapshot round trip
is byte-exact, and ``kv_pool``'s copy/extract/insert equal JAX's byte
for byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ContinuousEngine as JEngine
from repro.serve import FaultInjector as JFaults
from repro.serve import kv_pool as jpool
from repro_torch import convert
from repro_torch.serve import (ContinuousEngine, CrashPoint, FaultInjector,
                               RequestStatus)
from repro_torch.serve import kv_pool as tpool
from repro_torch.serve import snapshot as tsnap
from test_torch_serve import (JRequest, TRequest, _assert_same,  # noqa: F401
                              _engine_pair, _pair, _serve_pair, master)

SEED = 7
STORM = dict(max_batch=3, kv_blocks=9, block_size=4, max_blocks_per_req=8,
             segment_len=4, seq_bucket=8, preemption="page_out")


def _specs(vocab, *, n=4, prompt_len=4, max_new=12, seed=3):
    rng = np.random.default_rng(seed)
    return [dict(rid=10 + i, prompt=rng.integers(0, vocab, prompt_len),
                 max_new=max_new, arrival_step=i) for i in range(n)]


def _port(master, int8=False, **kw):
    cfg, tc, _, tplan, _, tp = _pair(master, "w8a8_kernel", int8, "w8a8")
    return ContinuousEngine(tp, tc, plan=tplan, device="cpu",
                            **dict(STORM, **kw))


def _identical(got, want):
    """Tokens AND logprobs bit-identical, every request OK."""
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].status is RequestStatus.OK, (rid, got[rid].status)
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        np.testing.assert_array_equal(got[rid].logprobs, want[rid].logprobs)


def _key(temperature):
    return np.array([0, SEED], np.uint32) if temperature else None


# ---------------------------------------------------------------------------
# Snapshot / restore / crash recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,int8", [(0.0, False), (0.8, True)])
def test_crash_restore_resume_bit_identity(master, tmp_path, temperature,
                                           int8):
    """Kill the loop with a CrashPoint; a fresh engine restores the last
    periodic snapshot and every request completes bit-identically to the
    uninterrupted run, whose tokens equal the JAX engine's."""
    je, base, cfg = _engine_pair(master, int8, **STORM)
    specs = _specs(cfg.vocab)
    reqs = [TRequest(**s) for s in specs]
    jr, ref = _serve_pair(je, base, specs, seed=SEED if temperature else None,
                          temperature=temperature)
    _assert_same(ref, jr)
    snap = dict(snapshot_dir=str(tmp_path), snapshot_interval=2)
    ce = _port(master, int8, **snap)
    crashed = {}
    with pytest.raises(CrashPoint):
        for ev in ce.run_stream(reqs, key=_key(temperature),
                                temperature=temperature,
                                faults=FaultInjector.crash_at(5)):
            if ev["event"] == "finish":
                crashed[ev["rid"]] = ev["result"]
    assert ce.last_snapshot_path is not None
    assert ce.last_run_snapshots >= 1
    assert len(crashed) < len(reqs)
    assert ce.allocator.live_blocks == 0 and len(ce.spill) == 0
    ce2 = _port(master, int8, **snap)
    ce2.restore(ce.last_snapshot_path)
    resumed = ce2.resume()
    assert ce2.last_run_recoveries >= 1
    _identical({**crashed, **resumed}, ref)
    names = {e["name"] for e in ce2.tracer.to_chrome()["traceEvents"]}
    assert "recover" in names


def test_crash_restore_resume_exact_plan(master, tmp_path):
    """Crash, restore and resume under the JAX test's float ``exact``
    plan: tokens equal JAX's uninterrupted run, logprobs within
    EXACT_MAX_ULP of the port's (a row's f32 CPU attention rounds with its
    neighbours' lengths; see test_torch_serve_pageout)."""
    from test_torch_serve_pageout import EXACT_MAX_ULP
    je, base, cfg = _engine_pair(master, False, "exact", None, **STORM)
    specs = _specs(cfg.vocab)
    reqs = [TRequest(**s) for s in specs]
    jr, ref = _serve_pair(je, base, specs)
    _assert_same(ref, jr, logprobs=None)
    _, tc, _, tplan, _, tp = _pair(master, "exact", False)

    def port():
        return ContinuousEngine(tp, tc, plan=tplan, device="cpu",
                                snapshot_dir=str(tmp_path),
                                snapshot_interval=2, **STORM)
    ce = port()
    crashed = {}
    with pytest.raises(CrashPoint):
        for ev in ce.run_stream(reqs, faults=FaultInjector.crash_at(5)):
            if ev["event"] == "finish":
                crashed[ev["rid"]] = ev["result"]
    assert len(crashed) < len(reqs)
    ce2 = port()
    ce2.restore(ce.last_snapshot_path)
    got = {**crashed, **ce2.resume()}
    assert ce2.last_run_recoveries >= 1
    _assert_same(got, jr, logprobs=None)
    for rid in ref:
        assert got[rid].status is RequestStatus.OK
        np.testing.assert_array_max_ulp(got[rid].logprobs,
                                        ref[rid].logprobs, EXACT_MAX_ULP)


def test_drain_snapshots_and_warm_restart_completes(master, tmp_path):
    """drain(deadline) stops admissions, spills the stragglers, writes a
    final snapshot and ends the run with a 'drain' event; a warm restart
    serves the remainder bit-identically."""
    je, base, cfg = _engine_pair(master, **STORM)
    specs = _specs(cfg.vocab)
    reqs = [TRequest(**s) for s in specs]
    jr, ref = _serve_pair(je, base, specs)
    _assert_same(ref, jr)
    ce = _port(master, snapshot_dir=str(tmp_path))
    early, drain_ev = {}, None
    for i, ev in enumerate(ce.run_stream(reqs)):
        if ev["event"] == "finish":
            early[ev["rid"]] = ev["result"]
        elif ev["event"] == "drain":
            drain_ev = ev
        if i == 4:
            ce.drain(deadline_steps=4)
    assert drain_ev is not None, "drain latched but never completed"
    assert drain_ev["running"] == 0       # page_out: stragglers all spill
    assert len(early) < len(reqs), "drain test finished too early"
    ce2 = _port(master, snapshot_dir=str(tmp_path)).restore(drain_ev["path"])
    _identical({**early, **ce2.resume()}, ref)


def test_restore_rejects_geometry_mismatch(master, tmp_path):
    """A snapshot only restores into an identically shaped engine; the
    right geometry restores and serves everything from the queue."""
    cfg, *_ = _pair(master, "exact", False)
    ce = _port(master, snapshot_dir=str(tmp_path))
    ce.drain(deadline_steps=0)
    reqs = [TRequest(**s) for s in _specs(cfg.vocab)]
    drain_ev = next(ev for ev in ce.run_stream(reqs)
                    if ev["event"] == "drain")
    with pytest.raises(ValueError, match="geometry"):
        _port(master, kv_blocks=11).restore(drain_ev["path"])
    res = _port(master).restore(drain_ev["path"]).resume()
    _identical(res, _port(master).run(reqs))


def test_snapshot_requires_active_run_at_boundary(master, tmp_path):
    cfg, *_ = _pair(master, "exact", False)
    ce = _port(master)
    with pytest.raises(RuntimeError, match="idle"):
        ce.snapshot(str(tmp_path / "s.npz"))
    stream = ce.run_stream([TRequest(**s) for s in _specs(cfg.vocab)])
    next(stream)
    with pytest.raises(RuntimeError, match="boundary"):
        ce.snapshot(str(tmp_path / "s.npz"))
    stream.close()
    with pytest.raises(ValueError, match="snapshot_dir"):
        ce.drain(3)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_jax_snapshot_restores_in_port(master, tmp_path, int8):
    """A snapshot the JAX engine writes at a crash point restores in the
    port, which finishes every in-flight request with JAX's greedy tokens;
    the port's snapshot of the restored state restores in the JAX engine,
    which finishes them the same way."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, "w8a8_kernel", int8, "w8a8")
    specs = _specs(cfg.vocab)
    jreqs = [JRequest(**s) for s in specs]
    kw = dict(STORM)
    ref = JEngine(jp, cfg, plan=jplan, **kw).run(jreqs)
    jdir = tmp_path / "jax"
    je = JEngine(jp, cfg, plan=jplan, snapshot_dir=str(jdir),
                 snapshot_interval=2, **kw)
    crashed = {}
    with pytest.raises(Exception, match="injected crash"):
        for ev in je.run_stream(jreqs, faults=JFaults.crash_at(5)):
            if ev["event"] == "finish":
                crashed[ev["rid"]] = ev["result"]
    assert len(crashed) < len(specs)
    te = ContinuousEngine(tp, tc, plan=tplan, device="cpu", **kw)
    te.restore(je.last_snapshot_path)
    assert te.spill.rids() or te.allocator.live_blocks
    port_path = te.snapshot(str(tmp_path / "port" / "snap.npz"))
    resumed = te.resume()
    _assert_same({**crashed, **resumed}, ref)
    je2 = JEngine(jp, cfg, plan=jplan, **kw).restore(port_path)
    _assert_same({**crashed, **resumed}, {**crashed, **je2.resume()})


@pytest.mark.parametrize("int8", [False, True])
def test_port_snapshot_round_trip_byte_exact(master, tmp_path, int8):
    """Restoring a port snapshot and writing it again gives the same
    arrays byte for byte and the same meta record."""
    cfg, *_ = _pair(master, "exact", int8)
    ce = _port(master, int8, snapshot_dir=str(tmp_path / "a"),
               snapshot_interval=1)
    reqs = [TRequest(**s) for s in _specs(cfg.vocab)]
    with pytest.raises(CrashPoint):
        ce.run(reqs, faults=FaultInjector.crash_at(4))
    first = ce.last_snapshot_path
    ce2 = _port(master, int8).restore(first)
    second = ce2.snapshot(str(tmp_path / "b" / "snap.npz"))
    m1, a1 = tsnap.load_snapshot(first)
    m2, a2 = tsnap.load_snapshot(second)
    assert m1 == m2
    assert m1["bf16_arrays"] or not int8
    assert set(a1) == set(a2)
    for name in a1:
        assert a1[name].dtype == a2[name].dtype, name
        assert a1[name].tobytes() == a2[name].tobytes(), name
    assert a1["rng"].dtype == np.uint32 and a1["rng"].shape == (2,)


def _revival_specs(vocab):
    """A request, then one sharing its 8-token prefix that arrives long
    after it retired (its blocks cached-free, still indexed)."""
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, vocab, 8)
    return [dict(rid=50, prompt=np.concatenate(
                [sys_prompt, rng.integers(0, vocab, 3)]), max_new=4,
                arrival_step=0),
            dict(rid=51, prompt=np.concatenate(
                [sys_prompt, rng.integers(0, vocab, 4)]), max_new=5,
                arrival_step=40)]


def _drain_between(engine, reqs):
    """Drain as soon as the first request finished; returns its result
    and the snapshot path."""
    early, path = {}, None
    for ev in engine.run_stream(reqs):
        if ev["event"] == "finish":
            early[ev["rid"]] = ev["result"]
            engine.drain(deadline_steps=0)
        elif ev["event"] == "drain":
            path = ev["path"]
    return early, path


def test_restore_carries_cached_prefix_bytes(master, tmp_path):
    """A snapshot carries the bytes of cached-free prefix blocks, not
    only the live ones: after a restore a later request revives them and
    finishes as in the uninterrupted run.  A JAX-written file, which
    carries live blocks only, restores with those index entries dropped:
    the later request misses instead of reading zeroed pages, and still
    ends with the uninterrupted run's tokens."""
    kw = dict(max_batch=3, kv_blocks=32, block_size=4, max_blocks_per_req=8,
              segment_len=4, seq_bucket=8, preemption="page_out",
              prefix_cache=True)
    je, te, cfg = _engine_pair(master, False, "exact", None, **kw)
    specs = _revival_specs(cfg.vocab)
    jr, ref = _serve_pair(je, te, specs)
    _assert_same(ref, jr)
    assert te.last_run_prefix_hits == 1
    cfg_, tc, jplan, tplan, jp, tp = _pair(master, "exact", False)

    def port(**extra):
        return ContinuousEngine(tp, tc, plan=tplan, device="cpu",
                                **dict(kw, **extra))

    early, path = _drain_between(port(snapshot_dir=str(tmp_path / "t")),
                                 [TRequest(**s) for s in specs])
    meta, _ = tsnap.load_snapshot(path)
    assert meta["allocator"]["live"] == [] and meta["live_blocks"]
    ce = port().restore(path)
    _assert_same({**early, **ce.resume()}, ref)
    assert ce.last_run_prefix_hits == 1

    jearly, jpath = _drain_between(
        JEngine(jp, cfg_, plan=jplan, snapshot_dir=str(tmp_path / "j"),
                **kw), [JRequest(**s) for s in specs])
    ce = port().restore(jpath)
    assert ce.allocator.cached_blocks == 0
    _assert_same({**jearly, **ce.resume()}, jr)
    assert ce.last_run_prefix_hits == 0 and ce.last_run_prefix_misses == 1


# ---------------------------------------------------------------------------
# kv_pool: copy / extract / insert against JAX's
# ---------------------------------------------------------------------------

def _random_pools(master, int8, dtype_name):
    """The same random pool in both packages: (jax_pages, port_pages)."""
    cfg, *_ = _pair(master, "exact", int8)
    rng = np.random.default_rng(11)
    jdtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    jpages = jpool.init_pages(cfg, 9, 4, jdtype)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(a.dtype)

    jpages = jax.tree.map(lambda a: jnp.asarray(fill(a)), jpages)
    tpages = convert.pages_from_jax(jax.tree.map(np.asarray, jpages))
    return jpages, tpages


def _host_equal(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert g.shape == w.shape, name
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert g.dtype == w.dtype, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("int8,dtype_name", [(False, "f32"),
                                             (False, "bf16"),
                                             (True, "f32")])
def test_kv_pool_blocks_match_jax(master, int8, dtype_name):
    """extract_blocks returns JAX's leaves and shapes (bf16 as uint16 bit
    patterns); copy_block and insert_blocks (fed JAX's host arrays, or
    the port's own) leave the pool byte-equal to JAX's."""
    jpages, tpages = _random_pools(master, int8, dtype_name)
    ids = [5, 2, 7]
    want = jpool.extract_blocks(jpages, ids)
    _host_equal(tpool.extract_blocks(tpages, ids), want)
    if int8:
        assert want["k_scale"].shape[-1] == 1

    jpages = jpool.copy_block(jpages, 3, 8)
    assert tpool.copy_block(tpages, 3, 8) is tpages
    _host_equal(tpool.extract_blocks(tpages, range(9)),
                jpool.extract_blocks(jpages, range(9)))

    src = jpool.extract_blocks(jpages, [1, 4])
    jpages = jpool.insert_blocks(jpages, src, [6, 3])
    tpool.insert_blocks(tpages, src, [6, 3])
    _host_equal(tpool.extract_blocks(tpages, range(9)),
                jpool.extract_blocks(jpages, range(9)))
    own = tpool.extract_blocks(tpages, [8])
    tpool.insert_blocks(tpages, own, [2])
    jpages = jpool.insert_blocks(jpages, jpool.extract_blocks(jpages, [8]),
                                 [2])
    _host_equal(tpool.extract_blocks(tpages, range(9)),
                jpool.extract_blocks(jpages, range(9)))


def test_spill_store():
    store = tpool.SpillStore()
    entry = tpool.SpillEntry(kv={"k": np.zeros((2, 1, 4, 2, 8), np.float32),
                                 "v": np.zeros((2, 1, 4, 2, 8), np.float32)},
                             n_blocks=1, ctx_len=3, n_out=2, pending_tok=5)
    store.put(4, entry)
    assert 4 in store and len(store) == 1 and store.rids() == [4]
    assert entry.nbytes == store.total_bytes() == 2 * 2 * 4 * 2 * 8 * 4
    with pytest.raises(RuntimeError, match="already spilled"):
        store.put(4, entry)
    assert store.pop(4) is entry
    store.discard(4)
    assert len(store) == 0
    bf = torch.zeros(3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-bit"):
        tpool._from_host(np.zeros(3, np.float32), bf)

