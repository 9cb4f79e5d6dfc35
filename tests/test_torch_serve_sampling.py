"""Seeded sampling in the PyTorch ContinuousEngine: at a fixed key and
temperature the port draws the JAX engine's tokens on both prefill paths
(its sampler is ``jax.random``'s bit for bit), and a request's tokens do
not depend on the batch it is served in."""
import jax
import numpy as np
import pytest

from repro_torch import convert
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import Request as TRequest
from test_torch_serve import _pair, _run_both, _specs, master  # noqa: F401


def _keys(seed):
    key = jax.random.PRNGKey(seed)
    return key, convert.key_from_jax(np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("chunked,int8", [(True, False), (False, False),
                                          (True, True), (False, True)])
def test_sampled_streams_identical_to_jax(master, chunked, int8):
    """Temperature 0.8: tokens equal to JAX's, and logprobs within 1e-4
    over the float pool.  Over the int8 pool a one-ulp reordering
    difference can round one activation or KV code the other way, which
    moves a later logprob by up to about 0.1 (0.075 measured) while every
    token stays equal, so there the tokens are held."""
    jkey, tkey = _keys(21)
    cfg, *_ = _pair(master, "w8a8_kernel", int8, "w8a8")
    specs = _specs(cfg, n=5, seed=8)
    je, te, jr, tr = _run_both(
        master, "w8a8_kernel", int8, specs=specs, jax_plan="w8a8",
        chunked_prefill=chunked,
        run_kw=dict(jax=dict(key=jkey, temperature=0.8),
                    torch=dict(key=tkey, temperature=0.8)))
    greedy = te.run([TRequest(**s) for s in specs])
    assert any(not np.array_equal(tr[rid].tokens, greedy[rid].tokens)
               for rid in tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].status.value == jr[rid].status.value == "ok"
        if not int8:
            np.testing.assert_allclose(tr[rid].logprobs, jr[rid].logprobs,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunked", [True, False])
def test_batch_mix_invariance(master, chunked):
    """A request served alone draws the tokens it draws in a batch: its
    key folds its id and step, never its row or its neighbours."""
    cfg, tc, jplan, tplan, jp, tp = _pair(master, "w8a8_kernel", False)
    specs = _specs(cfg, n=5, seed=6)
    te = TEngine(tp, tc, plan=tplan, device="cpu", max_batch=3,
                 kv_blocks=40, block_size=4, max_blocks_per_req=16,
                 segment_len=4, chunked_prefill=chunked, prefill_chunk=8,
                 paged_attn=True)
    _, key = _keys(5)
    batch = te.run([TRequest(**s) for s in specs], key=key, temperature=0.9)
    for s in specs[1:4]:
        alone = te.run([TRequest(**dict(s, arrival_step=0))], key=key,
                       temperature=0.9)
        np.testing.assert_array_equal(alone[s["rid"]].tokens,
                                      batch[s["rid"]].tokens)
    assert te.allocator.free_blocks == te.allocator.capacity
