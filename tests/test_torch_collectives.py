"""The port's explicit collectives on 4 gloo ranks against the JAX
package's on 4 forced host devices (``AxisType.Auto`` meshes), on the
same numpy inputs:

* ``seq_parallel_decode_attention`` (B 2, S 64, H 8, KVH 4, D 16, 49
  valid) against JAX's and against the port's ``attend_decode``, at JAX's
  test tolerance (rtol 2e-4, atol 2e-5), from full tensors and from
  DTensors sharded on the sequence;
* ``compressed_psum``: the mean and the error state bit-exact against
  JAX's (its eager shard_map, as JAX's own test runs it) after one
  reduction and after 3 error-feedback rounds (so are the int8 codes and
  the shared scale they imply), and within JAX's own one-shot (< 0.05)
  and 20-round (< 0.005) bounds;
* ``pipeline_forward``, 4 stages x 8 microbatches, against JAX's and the
  sequential stages within 2e-6;
* ``sharding.constrain`` on a 2 x 2 mesh redistributes a DTensor.

The ranks run in one ``launch.mesh.spawn`` of their own with a join
timeout; the JAX side in a subprocess."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, KVH, D, N_VALID = 2, 64, 8, 4, 16, 49
N_STAGES, N_MICRO, MB, DP = 4, 8, 2, 16
ROUNDS = 20
# Rounds held bit for bit against JAX's eager shard_map (~1.3 s a call on
# the CPU); JAX's jit fuses the error update into an FMA, so the eager
# run is the reference, as in JAX's own test.
EXACT_ROUNDS = 3


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "q": rng.standard_normal((B, 1, H, D)).astype(f32),
        "k": rng.standard_normal((B, S, KVH, D)).astype(f32),
        "v": rng.standard_normal((B, S, KVH, D)).astype(f32),
        "g": (rng.standard_normal((4, 512)) * np.linspace(
            0.1, 3.0, 4)[:, None]).astype(f32),
        "ws": (rng.standard_normal((N_STAGES, DP, DP)) / np.sqrt(DP)
               ).astype(f32),
        "x": rng.standard_normal((N_MICRO, MB, DP)).astype(f32),
    }


_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, "src")
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.distributed.collectives import seq_parallel_decode_attention
from repro.distributed.pipeline import pipeline_forward
from repro.train import compression

inp = dict(np.load(sys.argv[1]))
auto = (jax.sharding.AxisType.Auto,)
out = {}
mesh = jax.make_mesh((4,), ("model",), axis_types=auto)
out["attn"] = np.asarray(seq_parallel_decode_attention(
    mesh, jnp.asarray(inp["q"]), jnp.asarray(inp["k"]),
    jnp.asarray(inp["v"]), jnp.asarray(%(n_valid)d)))

mesh = jax.make_mesh((4,), ("data",), axis_types=auto)
def reduce_once(g, err):   # eager, op by op, as JAX's own test runs it
    return compat.shard_map(
        partial(compression.compressed_psum, axis_name="data"),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
    )(g, err)
g = jnp.asarray(inp["g"])
out["mean1"], out["err1"] = map(np.asarray, reduce_once(g, jnp.zeros_like(g)))
applied, err = jnp.zeros_like(g), jnp.zeros_like(g)
for _ in range(%(rounds)d):
    o, err = reduce_once(g, err)
    applied = applied + o
out["applied"], out["err_n"] = np.asarray(applied), np.asarray(err)

mesh = jax.make_mesh((4,), ("pod",), axis_types=auto)
out["pipe"] = np.asarray(pipeline_forward(
    mesh, lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["ws"]),
    jnp.asarray(inp["x"])))
np.savez(sys.argv[2], **out)
"""


def _collectives_rank(rank, inp):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import \
        seq_parallel_decode_attention
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.train.compression import compressed_psum

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    mesh = mesh_lib.make_mesh((4,), ("model",), device="cpu")
    out["attn"] = seq_parallel_decode_attention(mesh, t["q"], t["k"], t["v"],
                                                N_VALID).numpy()
    kd, vd = (distribute_tensor(t[n], mesh, [Shard(1)]) for n in "kv")
    out["attn_dt"] = seq_parallel_decode_attention(mesh, t["q"], kd, vd,
                                                   N_VALID).numpy()

    mesh = mesh_lib.make_mesh((4,), ("data",), device="cpu")
    g = t["g"][rank:rank + 1]
    mean1, err1 = compressed_psum(g, torch.zeros_like(g), "data", mesh=mesh)
    applied, err = torch.zeros_like(g), torch.zeros_like(g)
    for i in range(ROUNDS):
        o, err = compressed_psum(g, err, "data", mesh=mesh)
        applied = applied + o
        if i + 1 == EXACT_ROUNDS:
            out.update(applied_exact=applied.numpy(), err_exact=err.numpy())
    out.update(mean1=mean1.numpy(), err1=err1.numpy(),
               applied=applied.numpy())

    mesh = mesh_lib.make_mesh((4,), ("pod",), device="cpu")

    def stage(w, x):
        return torch.tanh(x @ w)

    out["pipe"] = pipeline_forward(mesh, stage, t["ws"], t["x"]).numpy()
    wd = distribute_tensor(t["ws"], mesh, [Shard(0)])
    out["pipe_dt"] = pipeline_forward(mesh, stage, wd, t["x"]).numpy()

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    x = distribute_tensor(torch.arange(4 * 8 * 4 * 16, dtype=torch.float32)
                          .reshape(4, 8, 4, 16), mesh, [Replicate()] * 2)
    y = sharding.constrain(x, {0: "batch", 2: "model"})
    z = sharding.constrain(y, {2: None})
    odd = distribute_tensor(torch.zeros(3, 5), mesh, [Replicate()] * 2)
    out["constrain"] = (
        tuple(y.placements) == (Shard(0), Shard(2))
        and tuple(y.to_local().shape) == (2, 8, 2, 16)
        and tuple(z.placements) == (Shard(0), Replicate())
        and torch.equal(z.full_tensor(), x.full_tensor())
        and sharding.constrain(odd, {0: "batch", 1: "model"}) is odd)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX % {
            "n_valid": N_VALID, "rounds": EXACT_ROUNDS}),
         str(tmp / "in.npz"), str(tmp / "jax.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = mesh_lib.spawn(_collectives_rank, 4, device="cpu",
                              args=(inp,), timeout_s=120, threads=1)
        _, err = jax_proc.communicate(timeout=240)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, err[-4000:]
    return inp, dict(np.load(tmp / "jax.npz")), port


def test_seq_parallel_decode_attention_matches_jax_and_attend_decode(
        results):
    from repro_torch.models.attention import attend_decode
    inp, jax_out, port = results
    want = attend_decode(torch.from_numpy(inp["q"]),
                         torch.from_numpy(inp["k"]),
                         torch.from_numpy(inp["v"]),
                         (torch.arange(S) < N_VALID)[None]).numpy()
    for r in port:
        for key in ("attn", "attn_dt"):
            np.testing.assert_allclose(r[key], jax_out["attn"], rtol=2e-4,
                                       atol=2e-5)
            np.testing.assert_allclose(r[key], want, rtol=2e-4, atol=2e-5)
            np.testing.assert_array_equal(r[key], port[0]["attn"])


def test_compressed_psum_bit_exact_against_jax(results):
    inp, jax_out, port = results
    g = inp["g"]
    for key, jkey in (("mean1", "mean1"), ("err1", "err1"),
                      ("applied_exact", "applied"), ("err_exact", "err_n")):
        got = np.concatenate([r[key] for r in port])
        assert got.dtype == jax_out[jkey].dtype
        np.testing.assert_array_equal(got, jax_out[jkey], err_msg=key)
    # The shared scale and the int8 codes of the first round.
    scale = np.float32(max(np.abs(g).max(), 1e-12)) / np.float32(127.0)
    codes = (g - np.concatenate([r["err1"] for r in port])) / scale
    assert np.abs(codes - np.round(codes)).max() < 1e-3
    assert np.abs(np.round(codes)).max() <= 127
    exact = np.broadcast_to(g.mean(0, keepdims=True), g.shape)
    mean1 = np.concatenate([r["mean1"] for r in port])
    rel1 = np.linalg.norm(mean1 - exact) / np.linalg.norm(exact)
    assert rel1 < 0.05, rel1
    applied = np.concatenate([r["applied"] for r in port])
    rel = np.linalg.norm(applied - exact * ROUNDS) / np.linalg.norm(
        exact * ROUNDS)
    assert rel < 0.005, rel


def test_pipeline_forward_matches_jax_and_sequential(results):
    inp, jax_out, port = results
    want = inp["x"]
    for s in range(N_STAGES):
        want = np.tanh(want @ inp["ws"][s])
    for r in port:
        for key in ("pipe", "pipe_dt"):
            np.testing.assert_allclose(r[key], jax_out["pipe"], rtol=2e-5,
                                       atol=2e-6)
            np.testing.assert_allclose(r[key], want, rtol=2e-5, atol=2e-6)


def test_constrain_redistributes_a_dtensor(results):
    assert all(r["constrain"] for r in results[2])
