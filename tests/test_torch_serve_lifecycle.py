"""Port parity of the PyTorch ContinuousEngine's lifecycle against the
JAX package's: recompute preemption, worst-case reservation with stop
tokens, TIMEOUT / SHED / CANCELLED retirement.  Page-out, the prefix cache,
fault injection and snapshots have their own files
(``test_torch_serve_{pageout,prefix,faults,durability}.py``)."""
import numpy as np
import pytest

from repro.serve import ContinuousEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import Request as TRequest
from test_torch_serve import _pair, _run_both, _specs, master  # noqa: F401


@pytest.mark.parametrize("int8", [False, True])
def test_preemption_recompute_identical_to_jax(master, int8):
    """A pool too small for every request's growth forces recompute
    preemptions; streams stay identical to JAX's (which stay identical to
    an undisturbed run)."""
    je, te, jr, tr = _run_both(master, "w8a8_kernel", int8,
                               jax_plan="w8a8", kv_blocks=14, max_batch=4,
                               max_blocks_per_req=12)
    assert te.last_run_preemptions > 0
    assert te.last_run_preemptions == je.last_run_preemptions
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)


def test_reservation_mode_and_stop_tokens(master):
    cfg, *_ = _pair(master, "exact", False)
    specs = _specs(cfg, n=4, seed=3)
    for s in specs:
        s["stop_tokens"] = (7, 11)
        s["max_new"] = 12
    je, te, jr, tr = _run_both(master, "exact", False, specs=specs,
                               preemption="off")
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].finish_reason == jr[rid].finish_reason


def test_lifecycle_statuses(master):
    """TIMEOUT (deadline), SHED (bounded queue) and CANCELLED retire with
    every block returned, as in the JAX engine."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, "exact", True)
    specs = _specs(cfg, n=6, seed=4, arrivals=(0, 0, 0, 0, 1, 1))
    specs[0]["deadline_steps"] = 2
    specs[0]["max_new"] = 9
    kw = dict(max_batch=2, kv_blocks=40, block_size=4, max_blocks_per_req=16,
              segment_len=2, chunked_prefill=True, prefill_chunk=8,
              paged_attn=True, max_queue=2)
    results = {}
    for name, engine, req in (("jax", JEngine(jp, cfg, plan=jplan, **kw),
                               JRequest),
                              ("torch", TEngine(tp, tc, plan=tplan,
                                                device="cpu", **kw),
                               TRequest)):
        out = {}
        for ev in engine.run_stream([req(**s) for s in specs]):
            if ev["event"] == "admit" and ev["rid"] == 11:
                engine.cancel(11)
            if ev["event"] == "finish":
                out[ev["rid"]] = ev["result"]
        engine.allocator.check_invariants()
        assert engine.allocator.free_blocks == engine.allocator.capacity
        results[name] = out
    got = {rid: r.status.value for rid, r in results["torch"].items()}
    want = {rid: r.status.value for rid, r in results["jax"].items()}
    assert got == want
    assert {"timeout", "shed", "cancelled", "ok"} <= set(got.values())
    for rid, r in results["jax"].items():
        np.testing.assert_array_equal(results["torch"][rid].tokens, r.tokens)
