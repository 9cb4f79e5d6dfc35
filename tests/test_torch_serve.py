"""Port parity: the PyTorch ContinuousEngine against the JAX package's on
the same Request lists (chunked and blocking prefill over the paged pool,
greedy and sampled at a fixed key), with identical token streams,
identical statuses, and the allocator drained full at the end of every
run."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro.core import backend as jb
from repro.models import model as JM
from repro.serve import ContinuousEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import Request as TRequest


@pytest.fixture(scope="module")
def master():
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg))


def _pair(master, plan_name, int8, jax_plan=None):
    """Both packages' (cfg, plan, params).  ``jax_plan`` lets the JAX side
    run another backend of identical semantics: its ``w8a8`` oracle is
    bit-identical to its bias-free ``w8a8_kernel`` (test_torch_quant_
    backend) and far cheaper on the CPU than the Pallas interpreter."""
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    jplan = jb.load_plan(jax_plan or plan_name)
    tplan = tb.load_plan(plan_name)
    jp = jax.tree.map(jax.numpy.asarray, master)
    if plan_name != "exact":
        jp = JM.freeze_params(jp, a_scale=0.05, plan=jplan)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return cfg, tc, jplan, tplan, jp, tp


def _specs(cfg, n=5, seed=0, arrivals=(0, 0, 2, 5, 6)):
    rng = np.random.default_rng(seed)
    return [dict(rid=10 + i,
                 prompt=rng.integers(0, cfg.vocab, int(rng.integers(3, 40))),
                 max_new=int(rng.integers(2, 10)),
                 arrival_step=arrivals[i % len(arrivals)])
            for i in range(n)]


def _run_both(master, plan_name, int8, specs=None, jax_plan=None,
              run_kw=None, **kw):
    """Serve ``specs`` through both engines; ``run_kw`` holds each
    package's ``run`` arguments (``{"jax": {...}, "torch": {...}}``)."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, plan_name, int8, jax_plan)
    run_kw = run_kw or {"jax": {}, "torch": {}}
    specs = specs if specs is not None else _specs(cfg)
    kw = dict(dict(max_batch=3, kv_blocks=40, block_size=4,
                   max_blocks_per_req=16, segment_len=4,
                   chunked_prefill=True, prefill_chunk=8, paged_attn=True),
              **kw)
    je = JEngine(jp, cfg, plan=jplan, **kw)
    te = TEngine(tp, tc, plan=tplan, device="cpu", **kw)
    jr = je.run([JRequest(**s) for s in specs], **run_kw["jax"])
    tr = te.run([TRequest(**s) for s in specs], **run_kw["torch"])
    te.allocator.check_invariants()
    assert te.allocator.free_blocks == te.allocator.capacity
    return je, te, jr, tr


@pytest.mark.parametrize("plan_name,int8,jax_plan", [
    ("w8a8_kernel", True, None), ("w8a8_kernel", False, "w8a8"),
    ("exact", False, None)])
def test_streams_identical_to_jax(master, plan_name, int8, jax_plan):
    je, te, jr, tr = _run_both(master, plan_name, int8, jax_plan=jax_plan)
    assert set(jr) == set(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].status.value == jr[rid].status.value == "ok"
        assert tr[rid].finish_reason == jr[rid].finish_reason
        np.testing.assert_allclose(tr[rid].logprobs, jr[rid].logprobs,
                                   rtol=1e-4, atol=1e-4)
    assert te.last_run_segments == je.last_run_segments
    assert te.last_run_prefill_chunks == je.last_run_prefill_chunks



def _engine_pair(master, int8=False, plan_name="w8a8_kernel",
                 jax_plan="w8a8", **kw):
    """One JAX and one port ContinuousEngine built with the same keyword
    arguments over the same parameters; returns ``(je, te, cfg)``.

    The default plan is the served one, ``w8a8_kernel`` (JAX runs its
    bit-identical ``w8a8`` oracle): its int8 linears make a row's logits
    independent of the other rows of the batch.  Under the float
    ``exact`` plan the port's CPU logprobs of one request move by a few
    ulp with its batch neighbours (attend_decode's f32 contractions over
    the gathered key axis, whose length follows the batch's longest row,
    and the f32 linears, whose kernel follows max_batch), which would
    break the bit-identity the durability tests hold between differently
    loaded runs; their exact-plan cases hold an ulp bound instead."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, plan_name, int8, jax_plan)
    # A JAX engine compiles its programs once per instance: engines whose
    # runs leave nothing behind (no prefix index, no snapshots) are shared
    # between tests of one process.
    key = (int8, plan_name, jax_plan, tuple(sorted(kw.items())))
    stateless = not (kw.get("prefix_cache") or kw.get("snapshot_dir"))
    je = _JAX_ENGINES.get(key) if stateless else None
    if je is None:
        je = JEngine(jp, cfg, plan=jplan, **kw)
        if stateless:
            _JAX_ENGINES[key] = je
    return je, TEngine(tp, tc, plan=tplan, device="cpu", **kw), cfg


_JAX_ENGINES: dict = {}


def _serve_pair(je, te, specs, *, seed=None, temperature=0.0, faults=None):
    """Serve ``specs`` through both engines at ``jax.random.PRNGKey(seed)``
    (greedy without a seed).  ``faults`` maps a package's FaultInjector
    class to a fresh injector, so both runs get the same schedule.
    Returns ``(jax_results, port_results)``."""
    from repro.serve import FaultInjector as JFaults
    from repro_torch.serve import FaultInjector as TFaults
    key = None if seed is None else jax.random.PRNGKey(seed)
    jr = je.run([JRequest(**s) for s in specs], key=key,
                temperature=temperature,
                faults=None if faults is None else faults(JFaults))
    tr = te.run([TRequest(**s) for s in specs],
                key=None if key is None else np.asarray(key),
                temperature=temperature,
                faults=None if faults is None else faults(TFaults))
    return jr, tr


def _assert_same(tr, jr, *, logprobs=1e-4):
    """Port results equal JAX's: statuses, finish reasons and tokens, and
    logprobs within ``logprobs`` (None: tokens only)."""
    assert set(tr) == set(jr)
    for rid, j in jr.items():
        t = tr[rid]
        assert t.status.value == j.status.value, rid
        assert t.finish_reason == j.finish_reason, rid
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=str(rid))
        if logprobs is not None:
            np.testing.assert_allclose(t.logprobs, j.logprobs, rtol=logprobs,
                                       atol=logprobs, err_msg=str(rid))
