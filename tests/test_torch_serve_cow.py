"""Port parity of the prefix cache's exact-hit copy-on-write against the
JAX package's ContinuousEngine, with what ``tests/test_serve_prefix.py``
asserts of it: exact-duplicate, block-aligned prompts share every block;
the exact hit copies the shared tail page at admission and recomputes its
last block (blocking: the suffix prefill through ``prefill_chunk`` with
the write mask at 0; chunked: one write-skipped chunk), and the streams
equal the uncached engine's and JAX's, fp and int8, greedy and sampled."""
import numpy as np
import pytest

from repro_torch.serve import Request as TRequest
from test_torch_serve import _assert_same, _serve_pair, master  # noqa: F401
from test_torch_serve_prefix import (SEED, _assert_drained, _pair_mk,
                                     _same_counters, _tokens_equal)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_exact_duplicate_prompts_copy_on_write(master, int8, chunked):
    """Exact-duplicate, block-aligned prompts share every block; the
    exact hit copies the shared tail at admission and recomputes its last
    block without rewriting it.  Streams equal the uncached engine's and
    JAX's, and at least one copy fired."""
    rng = np.random.default_rng(3)
    _, base, cfg = _pair_mk(master, int8, prefix=False, chunked=chunked)
    je, te, _ = _pair_mk(master, int8, chunked=chunked)
    prompt = rng.integers(0, cfg.vocab, 12)      # 3 full blocks: exact hit
    specs = [dict(rid=40 + i, prompt=prompt.copy(), max_new=6,
                  arrival_step=2 * i) for i in range(3)]
    temperature = 0.8 if chunked else 0.0        # cover sampled CoW too
    ref = base.run([TRequest(**s) for s in specs],
                   key=np.array([0, SEED], np.uint32),
                   temperature=temperature)
    jr, res = _serve_pair(je, te, specs, seed=SEED, temperature=temperature)
    assert te.last_run_cow_copies >= 1
    assert te.last_run_prefix_hits >= 1
    _tokens_equal(res, ref)
    _assert_same(res, jr, logprobs=1e-2 if int8 else 1e-4)
    _same_counters(te, je)
    _assert_drained(te)
