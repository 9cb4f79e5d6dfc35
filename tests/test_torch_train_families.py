"""One train step of every arch of ``ARCH_IDS`` (reduced, f32) in the port
against the JAX package's jitted step, as ``tests/test_configs_smoke.py``
takes one for JAX alone: the dense and MoE decoders, the sliding window,
the encoder-decoder (frames), M-RoPE (embeddings and [3, B, S]
positions) and the state-space stacks.  Parameters are drawn by the JAX
package and carried across; inputs come from a numpy seed.  Loss,
``grad_norm``, parameters, ``m`` and ``v`` are held as in
``test_torch_train_steps.compare_step`` at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model as JM
from repro.train import optimizer as jo
from repro.train import train_loop as jtl
from repro_torch import configs as tcfg
from repro_torch.configs.base import TrainConfig
from repro_torch.train import train_loop as ttl
from test_torch_train_steps import STEP_KW, carried, compare_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small CPU ops
    gain nothing from more, and the suite runs several files at once on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return batch


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_one_train_step_matches_jax(arch):
    jc, tc = jcfg.reduced_config(arch), tcfg.reduced_config(arch)
    jp = JM.init(jax.random.PRNGKey(0), jc)
    jstate = jo.init_opt_state(jp)
    batch = _batch(jc, 7)
    tp, tstate = carried(jp, jstate, tc)
    jout = jax.jit(jtl.make_train_step(jc, JTrainConfig(**STEP_KW)))(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tout = ttl.make_train_step(tc, TrainConfig(**STEP_KW))(
        tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    worst = compare_step(jout, tout, tc, TrainConfig(**STEP_KW), 1e-5)
    assert np.isfinite(worst["loss"]) and float(tout[2]["grad_norm"]) > 0
    print(arch, worst)
