"""Port parity of page-out preemption (``preemption="page_out"``) against
the JAX package's ContinuousEngine, with what ``tests/test_serve_
durability.py`` asserts of page-out: a victim's KV bytes go to the host
and come back with no recompute, so its stream is bit-identical to an
undisturbed run -- tokens AND logprobs, fp and int8 pools -- and equal
to the JAX engine's on the same requests."""
import numpy as np
import pytest

from repro_torch.serve import RequestStatus
from repro_torch.serve import ContinuousEngine as TEngine
from test_torch_serve import (TRequest, _assert_same,  # noqa: F401
                              _engine_pair, _pair, _serve_pair, master)

SEED = 7
STORM = dict(max_batch=3, kv_blocks=9, block_size=4, max_blocks_per_req=8,
             segment_len=4, seq_bucket=8)


def _specs(cfg, *, n=4, prompt_len=4, max_new=12, seed=3):
    rng = np.random.default_rng(seed)
    return [dict(rid=10 + i, prompt=rng.integers(0, cfg.vocab, prompt_len),
                 max_new=max_new, arrival_step=i) for i in range(n)]


def _port(master, int8=False, **kw):
    """A port engine on the storm recipe (a pool two blocks short of the
    running set's worst case), with ``kw`` overriding it."""
    cfg, tc, _, tplan, _, tp = _pair(master, "w8a8_kernel", int8, "w8a8")
    return TEngine(tp, tc, plan=tplan, device="cpu", **dict(STORM, **kw))


def _identical(got, want, *, logprobs=True):
    """Bit identity of two port runs (the JAX test's contract)."""
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].status is RequestStatus.OK, (rid, got[rid].status)
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        if logprobs:
            np.testing.assert_array_equal(got[rid].logprobs,
                                          want[rid].logprobs)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("int8", [False, True])
def test_page_out_storm_bit_identity(master, temperature, int8):
    """A preemption storm under page_out resumes every victim from host
    bytes with zero recompute: tokens AND logprobs equal a storm-free run
    on a roomy pool, tokens equal recompute at the same pool size, and
    the streams and spill counts equal the JAX engine's."""
    je, te, cfg = _engine_pair(master, int8, preemption="page_out", **STORM)
    specs = _specs(cfg)
    seed = SEED if temperature else None
    jr, res = _serve_pair(je, te, specs, seed=seed, temperature=temperature)
    _assert_same(res, jr)
    reqs = [TRequest(**s) for s in specs]
    key = None if seed is None else np.array([0, seed], np.uint32)
    ref = _port(master, int8, preemption="recompute", kv_blocks=33).run(
        reqs, key=key, temperature=temperature)
    _identical(res, ref)
    rc = _port(master, int8, preemption="recompute").run(
        reqs, key=key, temperature=temperature)
    _identical(res, rc, logprobs=False)
    assert te.last_run_preemptions >= 1, "storm recipe produced no storm"
    assert te.last_run_spills == te.last_run_preemptions
    assert te.last_run_restores == te.last_run_spills
    assert te.last_run_spill_bytes > 0
    assert te.last_run_recomputes == 0, "page_out must never recompute"
    assert (te.last_run_spills, te.last_run_spill_bytes) == \
        (je.last_run_spills, je.last_run_spill_bytes)
    assert len(te.spill) == 0, "spill store must drain with the run"
    assert te.allocator.live_blocks == 0
    te.allocator.check_invariants()


# Under the float ``exact`` plan a row's CPU logprobs move by a few ulp
# with its batch neighbours: attend_decode's f32 contractions over the
# gathered key axis, whose length follows the batch's longest row, round
# differently at each length.  The exact-plan cases hold tokens equal and
# logprobs within this many ulp.
EXACT_MAX_ULP = 8


@pytest.mark.parametrize("int8", [False, True])
def test_page_out_storm_exact_plan(master, int8):
    """The storm under the JAX test's float ``exact`` plan: tokens equal
    JAX's and a storm-free run's, logprobs within EXACT_MAX_ULP of both,
    the same spills as JAX and no recompute."""
    je, te, cfg = _engine_pair(master, int8, "exact", None,
                               preemption="page_out", **STORM)
    specs = _specs(cfg)
    jr, res = _serve_pair(je, te, specs)
    _assert_same(res, jr, logprobs=None)
    _, tc, _, tplan, _, tp = _pair(master, "exact", int8)
    ref = TEngine(tp, tc, plan=tplan, device="cpu",
                  **dict(STORM, preemption="recompute", kv_blocks=33)).run(
        [TRequest(**s) for s in specs])
    _identical(res, ref, logprobs=False)
    for rid in ref:
        np.testing.assert_array_max_ulp(res[rid].logprobs,
                                        ref[rid].logprobs, EXACT_MAX_ULP)
        np.testing.assert_array_max_ulp(
            res[rid].logprobs, np.asarray(jr[rid].logprobs, np.float32),
            EXACT_MAX_ULP)
    assert te.last_run_spills >= 1 and te.last_run_recomputes == 0
    assert te.last_run_spills == je.last_run_spills


def test_page_out_chunked_prefill_falls_back(master):
    """Chunked prefill: a victim caught mid-prefill has no complete KV to
    spill and falls back to recompute; decoding victims still spill.
    Streams equal a recompute run's and the JAX engine's."""
    kw = dict(STORM, chunked_prefill=True, prefill_chunk=4)
    je, te, cfg = _engine_pair(master, preemption="page_out", **kw)
    specs = _specs(cfg, prompt_len=8)
    jr, res = _serve_pair(je, te, specs)
    _assert_same(res, jr)
    ref = _port(master, preemption="recompute", chunked_prefill=True,
                prefill_chunk=4).run([TRequest(**s) for s in specs])
    _identical(res, ref, logprobs=False)
    assert te.last_run_preemptions >= 1
    assert (te.last_run_spills + te.last_run_recomputes
            == te.last_run_preemptions)
    assert (te.last_run_spills, te.last_run_recomputes) == \
        (je.last_run_spills, je.last_run_recomputes)
    assert len(te.spill) == 0


def test_forced_preempt_spills_and_traces(master):
    """A scripted eviction in page_out mode goes through the spill path,
    shows up as spill / spill_restore spans in the trace, and the stream
    stays bit-identical to the fault-free run (and to JAX's faulted
    run)."""
    je, te, cfg = _engine_pair(master, preemption="page_out",
                               **dict(STORM, kv_blocks=17))
    specs = _specs(cfg, n=3)
    _, ref = _serve_pair(je, te, specs)
    assert te.last_run_preemptions == 0    # roomy pool: no organic storm
    jr, res = _serve_pair(
        je, te, specs, faults=lambda fi: fi.scripted({3: {"preempt": 1}}))
    _assert_same(res, jr)
    _identical(res, ref)
    assert te.last_run_spills >= 1 and te.last_run_restores >= 1
    assert te.last_run_spills == je.last_run_spills
    names = {e["name"] for e in te.tracer.to_chrome()["traceEvents"]}
    assert {"spill", "spill_restore", "fault:preempt"} <= names, names


@pytest.mark.parametrize("kw,match", [
    (dict(preemption="paged_out"), "preemption"),
    (dict(snapshot_interval=0, snapshot_dir="snaps"), "snapshot_interval"),
    (dict(snapshot_interval=2), "snapshot_dir"),
    (dict(preemption="off", prefix_cache=True), "preemptive")])
def test_config_checks(master, kw, match):
    """The engine rejects what the JAX engine rejects, with its words."""
    from repro.serve import ContinuousEngine as JEngine
    cfg, tc, jplan, tplan, jp, tp = _pair(master, "exact", False)
    with pytest.raises(ValueError, match=match):
        JEngine(jp, cfg, plan=jplan, **kw)
    with pytest.raises(ValueError, match=match):
        TEngine(tp, tc, plan=tplan, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(preemption="page_out"),
                                dict(preemption="page_out",
                                     chunked_prefill=True)])
def test_page_out_plain_run_ok(master, kw):
    """With room to spare page_out changes nothing: every request OK and
    the streams equal the JAX engine's."""
    je, te, cfg = _engine_pair(master, kv_blocks=16, block_size=4, **kw)
    jr, tr = _serve_pair(je, te, [dict(rid=1, prompt=[1, 2, 3],
                                       max_new=2)])
    assert tr[1].status is RequestStatus.OK
    _assert_same(tr, jr)
    assert te.last_run_spills == 0
