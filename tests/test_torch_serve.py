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

