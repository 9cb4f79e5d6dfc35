"""Port parity of the Mamba-2 block (``models/mamba2.py``) against the JAX
package's, function for function, at a reduced size in f32.

Inputs are drawn from numpy seeds; the block's parameters are drawn by
the JAX package (``init_mamba2``) and carried across by
``convert.params_from_jax``.  Tolerance 1e-5: the SSD's products are f32
sums taken in another order (XLA's einsum paths against the port's
pairwise steps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import mamba2 as jm
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.models import mamba2 as tm

TOL = 1e-5
B, H, P, N = 2, 4, 8, 16


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _ssd_inputs(seed, s):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, H, P))
    dt = rng.uniform(0.01, 0.2, (B, s, H))
    a = -np.exp(np.log(np.linspace(1.0, 16.0, H)))
    b = rng.standard_normal((B, s, 1, N))
    c = rng.standard_normal((B, s, 1, N))
    return [_both(v) for v in (x, dt, a, b, c)]


def test_segsum_matches_jax():
    xj, xt = _both(np.random.default_rng(0).standard_normal((2, 3, 8)))
    _close(tm._segsum(xt), jm._segsum(xj))


@pytest.mark.parametrize("s,chunk", [(32, 8), (48, 16), (5, 5)],
                         ids=["4-chunks", "3-chunks", "S<chunk"])
def test_ssd_chunked_matches_jax(s, chunk):
    """Several chunks (the inter-chunk recurrence) and one chunk shorter
    than the config's (``min(chunk, S)``): y and the final state."""
    ins = _ssd_inputs(s + chunk, s)
    yj, fj = jm.ssd_chunked(*[j for j, _ in ins], chunk)
    yt, ft = tm.ssd_chunked(*[t for _, t in ins], chunk)
    _close(yt, yj)
    _close(ft, fj)


def test_ssd_chunked_rejects_ragged_length():
    """``S % chunk != 0`` raises in both packages."""
    ins = _ssd_inputs(1, 12)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*[j for j, _ in ins], 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(*[t for _, t in ins], 8)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(2)
    vals = (rng.standard_normal((B, H, P, N)), rng.standard_normal((B, H, P)),
            rng.uniform(0.01, 0.2, (B, H)),
            -np.linspace(1.0, 16.0, H), rng.standard_normal((B, N)),
            rng.standard_normal((B, N)))
    ins = [_both(v) for v in vals]
    yj, sj = jm.ssd_decode_step(*[j for j, _ in ins])
    yt, st = tm.ssd_decode_step(*[t for _, t in ins])
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    k, ch = 4, 24
    xj, xt = _both(rng.standard_normal((B, 7, ch)))
    wj, wt = _both(rng.standard_normal((k, ch)))
    bj, bt = _both(rng.standard_normal(ch))
    sj = st = None
    if with_state:
        sj, st = _both(rng.standard_normal((B, k - 1, ch)))
    yj, nj = jm._causal_conv(xj, wj, bj, sj)
    yt, nt = tm._causal_conv(xt, wt, bt, st)
    _close(yt, yj)
    _close(nt, nj)


@pytest.fixture(scope="module")
def block():
    """(jax cfg, port cfg, jax block params, port block params): the
    reduced mamba2 config (d_model 64, 8 heads of 16, d_state 16, chunk
    8), f32."""
    jc = jcfg.reduced_config("mamba2-1.3b", n_layers=1)
    tc = tcfg.reduced_config("mamba2-1.3b", n_layers=1)
    jp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(4), jc))
    tp = convert.params_from_jax(jp, tc)
    return (jc, tc,
            jax.tree.map(lambda a: jnp.asarray(a[0]),
                         jp["stack"]["blocks"]["mamba"]),
            tp["stack"]["blocks"][0]["mamba"])


@pytest.mark.parametrize("s", [16, 6], ids=["2-chunks", "S<chunk"])
def test_block_prefill_then_decode_matches_jax(block, s):
    """``mamba2_block`` over a prompt with ``return_final_state``, then
    four decode steps from the carried states: y, the SSM state and the
    conv state within 1e-5 at every step."""
    jc, tc, jp, tp = block
    rng = np.random.default_rng(5 + s)
    xj, xt = _both(rng.standard_normal((B, s, jc.d_model)))
    yj, stj = jm.mamba2_block(jp, xj, jc, return_final_state=True)
    yt, stt = tm.mamba2_block(tp, xt, tc, return_final_state=True)
    _close(yt, yj)
    for name in ("ssm", "conv"):
        _close(stt[name], stj[name])
    assert stt["ssm"].dtype == torch.float32
    for step in range(4):
        xj, xt = _both(rng.standard_normal((B, 1, jc.d_model)))
        yj, stj = jm.mamba2_block(jp, xj, jc, state=stj)
        yt, stt = tm.mamba2_block(tp, xt, tc, state=stt)
        _close(yt, yj)
        for name in ("ssm", "conv"):
            _close(stt[name], stj[name])


def test_block_rejects_ragged_prompt(block):
    """A prompt longer than the chunk and not a multiple of it (12 with
    chunk 8) raises in both packages."""
    jc, tc, jp, tp = block
    xj, xt = _both(np.zeros((1, 12, jc.d_model)))
    with pytest.raises(AssertionError):
        jm.mamba2_block(jp, xj, jc)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.mamba2_block(tp, xt, tc)


def test_init_shapes_and_state_dtypes():
    """The port's own init draws the JAX package's shapes and dtypes, and
    its state starts at zero: an f32 SSM state and a conv state in the
    model dtype."""
    jc = jcfg.reduced_config("mamba2-1.3b", n_layers=1)
    tc = dataclasses.replace(tcfg.reduced_config("mamba2-1.3b", n_layers=1),
                             dtype="bfloat16")
    want = jax.eval_shape(lambda k: jm.init_mamba2(
        k, jc.d_model, jc.ssm, jnp.bfloat16), jax.random.PRNGKey(0))
    got = tm.init_mamba2(torch.Generator().manual_seed(0), tc.d_model,
                         tc.ssm, torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in got.values())
    for path, leaf in flat:
        t = got
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    st = tm.init_mamba_state(3, tc.d_model, tc.ssm, torch.bfloat16)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
    assert not st["ssm"].any() and not st["conv"].any()
