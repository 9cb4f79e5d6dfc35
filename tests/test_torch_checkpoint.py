"""The port's checkpoints, data stream, resume and train launcher against
the JAX package.

* JAX's own checkpoint cases (``tests/test_checkpoint.py``) on the port's
  ``CheckpointManager``: roundtrip with bf16 and int32 leaves, keep-k,
  async saves, and an interrupted save that never corrupts.
* The on-disk format crosses both ways bit for bit: a checkpoint JAX's
  manager wrote restores in the port, and JAX restores one the port
  wrote of the same tree (bf16 as a uint16 payload, "bfloat16" in the
  manifest).
* The slice as a whole: JAX's ``train_loop.run`` on reduced granite-moe
  (1 layer, d_model 32) stops at step 3; the port reads that checkpoint
  (``convert.train_state_from_jax``), saves it in its own layout and its
  ``run`` resumes to step 6: parameters within 1e-5 of JAX's
  uninterrupted 6-step run.  The port's own stop and resume is bit-exact
  against its uninterrupted run.
* ``lm_batch`` equals JAX's, and the train launcher trains on the CPU and
  resumes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import synthetic as js
from repro.train import train_loop as jtl
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            _flatten_with_paths)
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic as ts
from repro_torch.serve import prng
from repro_torch.train import optimizer as to
from repro_torch.train import train_loop as ttl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small CPU ops
    gain nothing from more, and the suite runs several files at once on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.standard_normal(3).astype(
                       np.float32)).to(torch.bfloat16),
                   "step": torch.tensor(7, dtype=torch.int32)},
        "lst": [torch.ones(2), torch.zeros(5)],
    }


def _equal(a, b):
    for x, y in zip(to.tree_leaves(a), to.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(3, tree)
    assert mgr.latest_step() == 3
    back = mgr.restore(3, tree, device="cpu")
    _equal(tree, back)
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert back["nested"]["step"].dtype == torch.int32


def test_keep_k_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000003", "step_000000004"]
    assert mgr.latest_step() == 4


def test_async_save_snapshots_first(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    want = tree["a"].clone()
    mgr.save_async(11, tree)
    tree["a"].add_(1.0)     # a write after the call does not reach the file
    mgr.wait()
    assert mgr.latest_step() == 11
    assert torch.equal(mgr.restore(11, tree, device="cpu")["a"], want)


def test_interrupted_save_never_corrupts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(5, tree)
    os.makedirs(os.path.join(tmp_path, "step_000000006.tmp-999"))
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(5, tree, device="cpu")["a"], tree["a"])


def test_format_crosses_both_ways(tmp_path):
    import ml_dtypes
    tree = _tree(1)
    jtree = jax.tree.map(lambda t: jnp.asarray(
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy()), tree)
    JManager(str(tmp_path / "jax"), keep=2).save(2, jtree)
    back = CheckpointManager(str(tmp_path / "jax")).restore(2, tree,
                                                            device="cpu")
    _equal(tree, back)
    CheckpointManager(str(tmp_path / "port")).save(4, tree)
    jback = JManager(str(tmp_path / "port")).restore(4, jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


ARCH = "granite-moe-1b-a400m"
RUN_KW = dict(lr=1e-3, total_steps=6, warmup_steps=1, checkpoint_every=3,
              remat=False)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jc = jcfg.reduced_config(ARCH, n_layers=1, d_model=32)
    tc = tcfg.reduced_config(ARCH, n_layers=1, d_model=32)
    want = jtl.run(jc, JTrainConfig(**RUN_KW), ckpt_dir=str(tmp_path / "a"),
                   steps=6, log_every=100)
    jtl.run(jc, JTrainConfig(**RUN_KW), ckpt_dir=str(tmp_path / "b"),
            steps=3, log_every=100)
    flat = CheckpointManager(str(tmp_path / "b")).load_flat(3)
    assert flat["params/stack/blocks/attn/q/w"].shape[0] == 1   # stacked
    params, opt = convert.train_state_from_jax(flat, tc)
    assert int(opt["step"]) == 3 and opt["step"].dtype == torch.int32
    CheckpointManager(str(tmp_path / "c")).save(3, {"params": params,
                                                    "opt": opt})
    got = ttl.run(tc, TrainConfig(**RUN_KW), ckpt_dir=str(tmp_path / "c"),
                  steps=6, log_every=100, device="cpu")
    assert [h["step"] for h in got["history"]] == [3, 4, 5]
    for key, jtree, ttree in (("params", want["params"], got["params"]),
                              ("m", want["opt_state"]["m"],
                               got["opt_state"]["m"]),
                              ("v", want["opt_state"]["v"],
                               got["opt_state"]["v"])):
        conv = _flatten_with_paths(convert.params_from_jax(
            jax.tree.map(np.asarray, jtree), tc))
        got_flat = _flatten_with_paths(ttree)
        assert set(conv) == set(got_flat)
        for path, a in conv.items():
            np.testing.assert_allclose(got_flat[path].numpy(), a.numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} {path}")
    assert int(got["opt_state"]["step"]) == 6


def test_port_resume_bit_exact(tmp_path):
    cfg = tcfg.reduced_config(ARCH, n_layers=1, d_model=32)
    tcfg_ = TrainConfig(**RUN_KW)
    a = ttl.run(cfg, tcfg_, ckpt_dir=str(tmp_path / "a"), steps=6,
                log_every=100, device="cpu")
    ttl.run(cfg, tcfg_, ckpt_dir=str(tmp_path / "b"), steps=3,
            log_every=100, device="cpu")
    b = ttl.run(cfg, tcfg_, ckpt_dir=str(tmp_path / "b"), steps=6,
                log_every=100, device="cpu")
    assert [h["step"] for h in b["history"]] == [3, 4, 5]
    _equal(a["params"], b["params"])
    _equal(a["opt_state"], b["opt_state"])
    assert [h["loss"] for h in a["history"][3:]] == \
        [h["loss"] for h in b["history"]]


@pytest.mark.parametrize("vocab", [256, 49155])
@pytest.mark.parametrize("seed", [0, 1])
def test_lm_batch_equals_jax(vocab, seed):
    seq = 256 if vocab > 1000 else 128
    for step in range(4):
        want = js.lm_batch(js.TokenStreamConfig(vocab, seq, 8, seed), step)
        got = ts.lm_batch(ts.TokenStreamConfig(vocab, seq, 8, seed), step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_geometric_equals_jax():
    """The geometric draw behind the token offsets, over 2**18 draws:
    XLA's f32 ``log`` may round one ulp away from torch's, which could
    move a ``floor``; none does here."""
    for seed in (0, 1):
        want = np.asarray(jax.random.geometric(jax.random.PRNGKey(seed), 0.2,
                                               (1 << 18,)))
        got = prng.geometric(prng.PRNGKey(seed), 0.2, (1 << 18,))
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_launcher_on_cpu(tmp_path):
    from repro_torch.launch import train as launch
    common = ["--arch", ARCH, "--device", "cpu", "--ckpt-dir",
              str(tmp_path)]
    out = launch.main(common + ["--steps", "2"])
    assert out["start"] == 0 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    out = launch.main(common + ["--steps", "4", "--plan", "qat"])
    assert out["start"] == 2
    assert [h["step"] for h in out["history"]] == [2, 3]
    # Auto-resume onto a mesh of 2 gloo ranks.
    out = launch.main(common + ["--steps", "5", "--devices", "2",
                                "--mesh-shape", "1,2"])
    assert out["start"] == 4 and [h["step"] for h in out["history"]] == [4]
    assert np.isfinite(out["history"][0]["loss"])
