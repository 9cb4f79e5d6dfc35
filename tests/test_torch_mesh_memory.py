"""Per-rank memory on the mesh in JAX's layout.

* A decode step over caches split as ``sharding.cache_specs(...,
  seq_shard=True)`` lays them out (``spmd.split_caches``) against the
  same steps over the caches the mesh serve holds (its rows, whole over
  the sequence), on a 2 x 2 (data, model) mesh of 4 gloo ranks: reduced
  qwen3-8b with an f32 and an int8 KV cache (the sequence split over
  'model', merged by the flash-decode combine of ``collectives``), reduced
  h2o-danube-3-4b (a sliding-window ring split over 'model'), reduced
  mamba2-1.3b (SSM states split by heads), zamba2-2.7b (both, the
  shared attention block's cache) and whisper-large-v3 (its cross K/V's
  frames split too).  Greedy tokens equal; the int8
  cache's codes and scales, gathered back, equal the unsplit cache's;
  logits within ``LOGIT_BOUND`` (the combine reorders the softmax sums:
  JAX's seq-parallel decode was 1.79e-7 off ``attend_decode``), mamba2's
  equal (its state is gathered whole for the step).
* A training gather's backward gives each rank its shard of the
  gradient summed over the batch axes (``batch_sum``, then the shard
  DTensor's ``redistribute`` keeps), for even, uneven and
  data-replicated leaves.
* A remat'd train step on the mesh (reduced zamba2, both remat
  policies: the gathers inside the checkpoint regions, run again in the
  recompute) against the single-device step.
  Its backward run in another thread (no mesh scope there, as in the
  autograd engine's CUDA thread) recomputes inside the call's scope.
* The dry run's traced temp bytes (``launch.dryrun.run_cell`` on a fake
  4 x 4 group, reduced qwen3-8b) grow by less than one gathered block's
  bytes from 2 to 4 layers, for a decode cell and a train cell: the
  model gathers one block at a time and a train step keeps gradient
  shards only.  A block's gathered bytes are what ``spmd.localize``
  allocates for it (its leaves sharded at rest; serving keeps the
  column-parallel linears' model shard).  A gather of the whole tree at
  once grew by 122,880 B a layer against such a block's 122,880
  (decode) and by 513,332 against 245,760 (train).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH, PROMPT, NEW, MAX_LEN = 4, 32, 6, 48
FRAMES = 16          # whisper's encoder frames: its cross K/V split too
# Largest |logit| (and float cache) difference allowed between the split
# and unsplit decode: ~10x the 4.1e-6 measured over these cases on the CPU
# (zamba2's; 1.4e-6-2.3e-6 for the others).
LOGIT_BOUND = 4e-5


def _cases():
    qwen = configs.reduced_config("qwen3-8b")
    return {"qwen3-8b": qwen,
            "qwen3-8b-int8kv": dataclasses.replace(qwen,
                                                   kv_cache_dtype="int8"),
            "h2o-danube-3-4b": configs.reduced_config("h2o-danube-3-4b"),
            "mamba2-1.3b": configs.reduced_config("mamba2-1.3b"),
            "zamba2-2.7b": configs.reduced_config("zamba2-2.7b"),
            "whisper-large-v3": configs.reduced_config("whisper-large-v3")}


def _decode_rank(rank):
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import model as M
    from repro_torch import prng
    from repro_torch.train import optimizer as opt_lib

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    out = {}
    for name, cfg in _cases().items():
        params = sharding.distribute(
            M.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
            sharding.resolve_param_specs(M.pspec(cfg), mesh))
        prompts = prng.randint(prng.PRNGKey(1), (BATCH, PROMPT), 0,
                               cfg.vocab)
        batch = {"tokens": prompts.long()}
        if cfg.arch_type == "encdec":
            batch["frames"] = torch.randn(
                (BATCH, FRAMES, cfg.d_model),
                generator=torch.Generator().manual_seed(2))
        batch = spmd.local_batch(batch, mesh)
        runs = {}
        with spmd.scope(mesh):
            logits, caches = M.prefill(params, batch, cfg, max_len=MAX_LEN)
            first = torch.argmax(logits[:, -1], dim=-1)
            for split in (False, True):
                c = opt_lib.tree_map(lambda x: x.clone(), caches)
                if split:
                    c = spmd.split_caches(c, mesh, cfg, seq_shard=True)
                tok, toks, lgs = first, [], []
                for _ in range(NEW):
                    lg, c = M.decode_step(params, {"tokens": tok[:, None]},
                                          c, cfg)
                    tok = torch.argmax(lg[:, -1], dim=-1)
                    toks.append(tok)
                    lgs.append(lg)
                runs[split] = (torch.stack(toks), torch.stack(lgs), c)
        split_c, whole_c = runs[True][2], runs[False][2]
        same = {}
        for path, dim in split_c.split.items():
            group, _, leaf = path.partition("/")
            got = split_c[group][leaf] if leaf else split_c[group]
            want = whole_c[group][leaf] if leaf else whole_c[group]
            full = spmd._model_gather(got, mesh, dim)
            same[path] = (bool(torch.equal(full, want)),
                          float((full.float() - want.float()).abs().max()))
        out[name] = {
            "tokens": (runs[False][0].numpy(), runs[True][0].numpy()),
            "logit_diff": float((runs[False][1] - runs[True][1]).abs().max()),
            "split": dict(split_c.split),
            "local_shapes": {p: tuple((split_c[p.partition("/")[0]]
                                       [p.partition("/")[2]]).shape)
                             for p in split_c.split if "/" in p},
            "gathered_equal": same}
    out["rest_grad"] = _rest_grad_cases(mesh, rank)
    out["remat"] = {policy: _remat_step(mesh, policy)
                    for policy in REMAT_POLICIES}
    out["remat_thread"] = _remat_in_another_thread(mesh)
    return out


def _remat_in_another_thread(mesh) -> bool:
    """A remat'd block's backward run in a thread of its own (where the
    autograd engine runs a CUDA graph's backward: no mesh scope there)
    gives the gradients of a backward inside the scope."""
    import threading

    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    cfg = configs.reduced_config("qwen3-8b")
    blk = sharding.distribute(
        transformer.init_dense_block(torch.Generator().manual_seed(0), cfg,
                                     torch.float32),
        sharding.resolve_param_specs(transformer.dense_block_pspec(cfg),
                                     mesh))
    rest = opt_lib.tree_leaves(blk)
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    fn = transformer._maybe_remat(lambda b, h: transformer.dense_block(
        spmd.gather_block(b), h, cfg)[0], True)

    def grads(in_thread):
        xs = [d.to_local().detach().requires_grad_(True) for d in rest]
        tree = opt_lib.tree_unflatten_like(
            blk, [spmd.Resting(a, d) for a, d in zip(xs, rest)])
        out = {}
        with spmd.scope(mesh, keep_model=False):
            y = fn(tree, x).square().sum()
            if not in_thread:
                return torch.autograd.grad(y, xs)
        t = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(y, xs)))
        t.start()
        t.join()
        return out.get("g")

    want, got = grads(False), grads(True)
    return got is not None and all(torch.equal(a, b)
                                   for a, b in zip(got, want))


REMAT_POLICIES = ("nothing", "dots")


def _train_cfg():
    return configs.reduced_config("zamba2-2.7b")


def _train_inputs():
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (8, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    params = M.init(_train_cfg(), torch.Generator().manual_seed(0),
                    device="cpu")
    return params, opt_lib.init_opt_state(params), batch


def _train_step(policy, mesh=None):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import train_loop
    return train_loop.make_train_step(
        _train_cfg(), TrainConfig(total_steps=10, warmup_steps=2,
                                  remat=True, remat_policy=policy),
        mesh=mesh)


def _remat_step(mesh, policy) -> dict:
    """One remat'd train step of reduced zamba2 (its shared attention
    block gathered once a group) on the mesh: the gathers sit inside the
    checkpoint regions and run again in the recompute."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop
    params, opt, batch = _train_inputs()
    psh = sharding.resolve_param_specs(M.pspec(_train_cfg()), mesh)
    params = sharding.distribute(params, psh)
    opt = {**{k: sharding.distribute(opt[k], psh)
              for k in ("master", "m", "v")}, "step": opt["step"]}
    with train_loop.deterministic():
        _, new_opt, mets = _train_step(policy, mesh)(params, opt, batch)
    return {"loss": float(mets["loss"]), "gnorm": float(mets["grad_norm"]),
            "m": [x.full_tensor().numpy()
                  for x in opt_lib.tree_leaves(new_opt["m"])]}


def _rest_grad_cases(mesh, rank) -> dict:
    """A training gather's backward (``spmd._rest_grad``: reduce-scatter
    over the batch axes, this rank's slice over 'model') against the
    summed gradient's shard (``batch_sum``, then the shard a replicated
    DTensor's ``redistribute`` to the leaf's layout keeps), for a leaf
    sharded on both axes, one whose data-sharded dim does not divide and
    one replicated over data."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.distributed import spmd
    out = {}
    for name, shape, placements in (
            ("even", (8, 6), (Shard(0), Shard(1))),
            ("uneven", (5, 6), (Shard(0), Shard(1))),
            ("replicated", (8, 6), (Replicate(), Shard(0)))):
        like = distribute_tensor(torch.zeros(shape), mesh, placements,
                                 src_data_rank=None)
        g = torch.randn(shape, generator=torch.Generator().manual_seed(rank))
        got = spmd._rest_grad(g, spmd.Resting(like.to_local(), like))
        want = DTensor.from_local(
            spmd.batch_sum(g, mesh), mesh, [Replicate()] * mesh.ndim,
            run_check=False).redistribute(mesh, placements).to_local()
        out[name] = bool(got.shape == like.to_local().shape
                         and torch.equal(got, want))
    return out


@pytest.fixture(scope="module")
def runs():
    """The 4 gloo ranks' results, and the dry-run temps traced in a
    process of their own (a fake group) at the same time."""
    proc = subprocess.Popen([sys.executable, "-c", _TEMP], cwd=ROOT,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        ranks = mesh_lib.spawn(_decode_rank, 4, device="cpu", timeout_s=150,
                               threads=1)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return {"ranks": ranks, "temps": json.loads(line[len("RESULT "):])}


@pytest.fixture(scope="module")
def decode_runs(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def temps(runs):
    return runs["temps"]


@pytest.mark.parametrize("name", list(_cases()))
def test_seq_split_decode_equals_unsplit(decode_runs, name):
    cfg = _cases()[name]
    for r in decode_runs:
        got = r[name]
        print(name, "max |logit diff|", got["logit_diff"], got["split"])
        whole, split = got["tokens"]
        assert np.array_equal(whole, split)
        assert got["split"], "nothing was split over 'model'"
        if cfg.ssm is not None:
            # Heads of the [L, B, H, P, N] state over 'model'.
            assert got["split"]["ssm/ssm"] == 2
            assert got["local_shapes"]["ssm/ssm"][2] * 2 == \
                cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim
        if cfg.arch_type == "ssm":
            assert got["logit_diff"] == 0.0
        else:
            assert got["split"]["kv/k"] == 2 and got["split"]["kv/v"] == 2
            assert got["logit_diff"] < LOGIT_BOUND
        if cfg.arch_type == "encdec":
            assert got["split"]["cross_k"] == 2
        if cfg.kv_cache_dtype == "int8":
            assert {"kv/k_scale", "kv/v_scale"} <= set(got["split"])
        # Every split leaf gathered back is the unsplit decode's: int8
        # codes and scales exactly, float k/v within the logits' bound
        # (they come from hidden states the combine moved by an ulp).
        for path, (equal, diff) in got["gathered_equal"].items():
            if cfg.kv_cache_dtype == "int8":
                assert equal, (path, diff)
            else:
                assert diff < LOGIT_BOUND, (path, diff)


@pytest.mark.parametrize("case", ["even", "uneven", "replicated"])
def test_gradient_shards_are_the_summed_gradients_shards(decode_runs, case):
    assert all(r["rest_grad"][case] for r in decode_runs)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_mesh_train_step_matches_one_device(decode_runs, policy):
    """The bounds of ``test_torch_mesh_train.py``'s ``_assert_close`` on
    m and grad_norm (measured here: m 1.3e-9 off, of 2.7e-3)."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop
    params, opt, batch = _train_inputs()
    with train_loop.deterministic():
        _, want_opt, want = _train_step(policy)(params, opt, batch)
    want_m = [x.numpy() for x in opt_lib.tree_leaves(want_opt["m"])]
    scale = max(float(np.abs(x).max()) for x in want_m)
    for r in decode_runs:
        got = r["remat"][policy]
        assert abs(got["loss"] - float(want["loss"])) < 1e-3
        assert abs(got["gnorm"] - float(want["grad_norm"])) \
            < 1e-5 * float(want["grad_norm"])
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(got["m"], want_m))
        assert diff < 1e-5 * scale, (diff, scale)


def test_remat_recompute_keeps_the_mesh_scope_in_another_thread(
        decode_runs):
    assert all(r["remat_thread"] for r in decode_runs)


_TEMP = """
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(1)
from repro_torch import configs as cfg_lib
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed import sharding, spmd
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import transformer

get = cfg_lib.get_config
LAYERS = [2]

def reduced(arch):
    cfg_lib.get_config = get
    try:
        return cfg_lib.reduced_config(arch, n_layers=LAYERS[0])
    finally:
        cfg_lib.get_config = reduced

cfg_lib.get_config = reduced
SHAPES["d_mem"] = ShapeConfig("d_mem", "decode", 64, 16)
SHAPES["t_mem"] = ShapeConfig("t_mem", "train", 32, 16)
mesh_lib.init_fake_group(16)
mesh = mesh_lib.make_mesh((4, 4), device="cpu")
out = {}
for shape in ("d_mem", "t_mem"):
    for n in (2, 4):
        LAYERS[0] = n
        r = dryrun.run_cell("qwen3-8b", shape, "single", device="cpu",
                            mesh=mesh)
        out[f"{shape}/{n}"] = r["memory"]["temp_bytes"]
# One block's gathered bytes: what its gather allocates (the leaves
# sharded at rest; serving keeps the column shards).
cfg = cfg_lib.reduced_config("qwen3-8b")
blk = transformer.init_dense_block(torch.Generator().manual_seed(0), cfg,
                                   torch.float32)
spec = transformer.dense_block_pspec(cfg)
blk = sharding.distribute(blk, sharding.resolve_param_specs(spec, mesh))

def leaves(t):
    return ([x for v in t.values() for x in leaves(v)]
            if isinstance(t, dict) else [t])

for shape, keep in (("d_mem", True), ("t_mem", False)):
    local = spmd.localize(blk, keep_model=keep)
    out[f"{shape}/block"] = sum(
        t.numel() * t.element_size()
        for r, t in zip(leaves(blk), leaves(local))
        if any(p.is_shard() for p in r.placements))
print("RESULT " + json.dumps(out))
"""


@pytest.mark.parametrize("shape", ["d_mem", "t_mem"])
def test_traced_temp_grows_less_than_a_block_per_layer(temps, shape):
    slope = (temps[f"{shape}/4"] - temps[f"{shape}/2"]) / 2
    block = temps[f"{shape}/block"]
    print(f"{shape}: temp {temps[f'{shape}/2']} B at 2 layers, "
          f"{temps[f'{shape}/4']} at 4; {slope:.0f} B a layer against a "
          f"gathered block of {block} B")
    assert block > 0
    assert slope < block
