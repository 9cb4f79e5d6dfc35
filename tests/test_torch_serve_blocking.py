"""Port parity of blocking prefill in the PyTorch ContinuousEngine (the
default, ``chunked_prefill=False``): one ``model.prefill_paged`` per
admission -- a bucketed prompt forward into a dense scratch cache,
scattered into the pool by ``kv_pool.pack_prompt`` -- then the decode
segments.  Streams are held against the JAX engine's on the same
Request lists, and ``pack_prompt`` against JAX's byte for byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serve import kv_pool as jpool
from repro_torch import convert
from repro_torch.models import model as TM
from repro_torch.serve import kv_pool as tpool
from test_torch_serve import _pair, _run_both, master  # noqa: F401


@pytest.mark.parametrize("plan_name,int8,paged_attn,jax_plan", [
    ("w8a8_kernel", True, True, "w8a8"),
    ("w8a8_kernel", False, False, "w8a8"),
    ("exact", True, False, None), ("exact", False, True, None)])
def test_blocking_streams_identical_to_jax(master, plan_name, int8,
                                           paged_attn, jax_plan):
    je, te, jr, tr = _run_both(master, plan_name, int8, jax_plan=jax_plan,
                               chunked_prefill=False, paged_attn=paged_attn)
    assert set(jr) == set(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].status.value == jr[rid].status.value == "ok"
        assert tr[rid].finish_reason == jr[rid].finish_reason
        np.testing.assert_allclose(tr[rid].logprobs, jr[rid].logprobs,
                                   rtol=1e-4, atol=1e-4)
    assert te.last_run_prefills == je.last_run_prefills == len(jr)
    assert te.last_run_prefill_chunks == 0
    assert te.last_run_segments == je.last_run_segments


def _pages_equal(tpages, jpages, int8, skip_null=True):
    """Byte equality of the port's pool and the JAX pool (numpy leaves),
    leaving out the null block 0 when ``skip_null``."""
    lo = 1 if skip_null else 0
    for name in ("k", "v"):
        if int8:
            pairs = ((tpages[name].q, jpages[name].q),
                     (tpages[name].scale, jpages[name].scale))
        else:
            pairs = ((tpages[name], jpages[name]),)
        for t, j in pairs:
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            j = np.asarray(j)
            j = j.view(np.int16) if j.dtype.name == "bfloat16" else j
            if not np.array_equal(t.numpy()[:, lo:], j[:, lo:]):
                return False
    return True


@pytest.mark.parametrize("int8", [False, True])
def test_pack_prompt_byte_equal_to_jax(master, int8):
    """The same dense cache scattered into the same pool: every page but
    the null block, which takes the padding chunks, equals JAX's byte for
    byte."""
    cfg, tc, *_ = _pair(master, "exact", int8)
    rng = np.random.default_rng(4)
    lyr, kvh, hd, bs, s = cfg.n_layers, cfg.n_kv_heads, \
        cfg.resolved_head_dim, 4, 16
    jpages = jax.tree.map(np.asarray,
                          jpool.init_pages(cfg, 9, bs, jnp.float32))
    shape = (lyr, 1, s, kvh, hd)
    if int8:
        dense = {n: rng.integers(-127, 128, shape).astype(np.int8)
                 for n in ("k", "v")}
        for n in ("k", "v"):
            dense[f"{n}_scale"] = rng.random(shape[:-1]).astype(
                jnp.bfloat16)
    else:
        dense = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}
    table = np.array([5, 2, 7, 0], np.int32)
    want = jax.tree.map(np.asarray, jpool.pack_prompt(
        jax.tree.map(jnp.asarray, jpages),
        {n: jnp.asarray(a) for n, a in dense.items()}, jnp.asarray(table)))
    tpages = convert.pages_from_jax(jpages)
    got = tpool.pack_prompt(
        tpages, {n: convert.tensor_from_numpy(a) for n, a in dense.items()},
        torch.as_tensor(table))
    assert got is tpages
    assert _pages_equal(got, want, int8)
    assert not _pages_equal(convert.pages_from_jax(jpages), want, int8)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_paged_matches_jax(master, int8):
    """model.prefill_paged end to end: logits within 1e-4; int8 pages
    byte-equal (the codes absorb the reordering), float pages within
    1e-4."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, "w8a8_kernel", int8,
                                          "w8a8")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = np.random.default_rng(3).integers(0, cfg.vocab, 10)
    table = np.array([5, 2, 7, 0], np.int32)
    jl, jpages = JM.prefill_paged(
        jp, {"tokens": jnp.asarray(toks), "length": jnp.asarray(10)}, cfg,
        pages=jpool.init_pages(cfg, 9, 4, jnp.float32),
        block_table=jnp.asarray(table), max_len=16, mode=jplan)
    tl, tpages = TM.prefill_paged(
        tp, {"tokens": torch.as_tensor(toks).long(), "length": 10}, tc,
        pages=tpool.init_pages(tc, 9, 4, torch.float32, device="cpu"),
        block_table=torch.as_tensor(table), max_len=16, mode=tplan)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    want = jax.tree.map(np.asarray, jpages)
    if int8:
        assert _pages_equal(tpages, want, int8)
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(tpages[name].numpy()[:, 1:],
                                       want[name][:, 1:], rtol=1e-4,
                                       atol=1e-4)
