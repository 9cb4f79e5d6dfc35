"""Port parity: the reduced qwen3-8b model's paged prefill chunks and
decode steps against the JAX package, plan by plan.

Each plan's port logits are held against the *same* plan's JAX logits
(not against ``exact``: W8A8 quantization error is not what is measured,
ROADMAP queue 3).  Parameters are drawn once by the JAX package and carried
across through numpy; both packages then freeze them themselves.  Tolerance
1e-4 on f32 logits: the linears are bit-exact, the norms, rotary and
attention sum f32 values in another order; greedy tokens must agree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import backend as jb
from repro.models import model as JM
from repro.serve import kv_pool as jpool
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import model as TM
from repro_torch.serve import kv_pool as tpool

BS, NB, W, CHUNK, PROMPT = 4, 12, 6, 8, 10
PLANS = {
    "exact": dict(default="exact"),
    "w8a8": dict(default="w8a8"),
    "w8a8_residency": dict(default="w8a8", residency=True),
    "w8a8_kernel": dict(default="w8a8_kernel"),
}


@pytest.fixture(scope="module")
def master():
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg))


def _setup(master, plan_name, paged_attn, int8):
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    kw = dict(PLANS[plan_name], paged_attn=paged_attn)
    jplan, tplan = jb.DeploymentPlan(**kw), tb.DeploymentPlan(**kw)
    jp = jax.tree.map(jnp.asarray, master)
    tp = convert.params_from_jax(master, tc)
    if plan_name != "exact":
        jp = JM.freeze_params(jp, a_scale=0.05, plan=jplan)
        tp = TM.freeze_params(tp, a_scale=0.05, plan=tplan)
    return cfg, tc, jplan, tplan, jp, tp


@pytest.mark.parametrize("plan_name,paged_attn,int8", [
    ("exact", True, False), ("exact", False, True),
    ("w8a8", True, True), ("w8a8_residency", True, True),
    ("w8a8_kernel", True, True), ("w8a8_kernel", False, False)])
def test_prefill_and_decode_logits_match_jax(master, plan_name, paged_attn,
                                             int8):
    cfg, tc, jplan, tplan, jp, tp = _setup(master, plan_name, paged_attn,
                                           int8)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (1, PROMPT)).astype(np.int32)
    tables = np.zeros((1, W), np.int32)
    tables[0, :4] = [2, 5, 1, 7]
    jpages = jpool.init_pages(cfg, NB, BS, jnp.float32)
    tpages = tpool.init_pages(tc, NB, BS, torch.float32, device="cpu")
    for c0 in range(0, PROMPT, CHUNK):
        cnt = min(CHUNK, PROMPT - c0)
        sl = np.zeros((1, CHUNK), np.int32)
        sl[0, :cnt] = prompt[0, c0:c0 + cnt]
        args = dict(pos=np.array([c0], np.int32),
                    n_tok=np.array([cnt], np.int32),
                    write_mask=np.array([True]), has_past=c0 > 0)
        jl, jpages = JM.prefill_chunk(
            jp, jnp.asarray(sl), cfg, pages=jpages,
            block_tables=jnp.asarray(tables), mode=jplan,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in args.items()})
        tl, tpages = TM.prefill_chunk(
            tp, torch.as_tensor(sl).long(), tc, pages=tpages,
            block_tables=torch.as_tensor(tables), mode=tplan,
            **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in args.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tok[0] == int(tl.argmax(-1)[0])
    lens = np.array([PROMPT], np.int32)
    for _ in range(2):
        jcache = {"kv": jpages, "block_tables": jnp.asarray(tables),
                  "lens": jnp.asarray(lens)}
        tcache = {"kv": tpages, "block_tables": torch.as_tensor(tables),
                  "lens": torch.as_tensor(lens)}
        jl, jcache = JM.decode_step(jp, {"tokens": jnp.asarray(tok)[:, None]},
                                    jcache, cfg, mode=jplan)
        tl, tcache = TM.decode_step(
            tp, {"tokens": torch.as_tensor(tok).long()[:, None]}, tcache, tc,
            mode=tplan)
        jpages = jcache["kv"]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        assert tok[0] == int(tl[:, -1].argmax(-1)[0])
        lens = lens + 1


def test_full_forward_matches_jax(master):
    """The cache-free full-sequence forward (attend_full) in the exact
    plan."""
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    tp = convert.params_from_jax(master, tc)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    jh, _ = JM.forward(jax.tree.map(jnp.asarray, master),
                       {"tokens": jnp.asarray(toks)}, cfg)
    th, _ = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        TM.logits_fn(tp, th, tc).numpy(),
        np.asarray(JM.logits_fn(jax.tree.map(jnp.asarray, master), jh, cfg)),
        rtol=1e-4, atol=1e-4)


def test_init_draws_from_generator():
    """Port init is seeded by an explicit generator, deterministic, and
    shaped like the JAX tree."""
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    a = TM.init(tc, torch.Generator().manual_seed(5), device="cpu")
    b = TM.init(tc, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["stack"]["blocks"][1]["mlp"]["up"]["w"],
                       b["stack"]["blocks"][1]["mlp"]["up"]["w"])
    assert a["lm_head"]["w"].shape == (tc.d_model, tc.padded_vocab)
    assert len(a["stack"]["blocks"]) == tc.n_layers
