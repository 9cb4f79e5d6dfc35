"""The port's static serving on a mesh, and the mesh launchers.

* ``launch.serve.static_generate`` on a 2 x 2 (data, model) mesh of 4
  gloo ranks -- params frozen and laid out by ``resolve_param_specs``,
  each rank serving its rows, the column-parallel linears (and MoE expert
  banks) on its model shard, the row-parallel ones gathered -- against
  the same call on one device: greedy tokens equal and the prefill
  logits bit-identical (every int8 product is exact and each output
  column sees its full K) under ``w8a8`` and ``w8a8_kernel`` (K1's plain
  twin on the CPU) for qwen3-8b, granite-moe-1b-a400m (experts split over
  'model') and mamba2-1.3b (reduced configs).
* The launchers run to their end on 2 gloo ranks (``--device cpu
  --devices 2 --mesh-shape 1,2``): serve qwen3-8b with the single-device
  tokens; train granite-moe-1b-a400m 3 steps, then resume from its
  checkpoint onto a 2 x 1 mesh.  ``--devices 2`` on CUDA with fewer cards
  raises, naming both counts; under a two-node torchrun the check counts
  this node's ranks (``LOCAL_WORLD_SIZE``), not the whole group.
* A CPU rehearsal of ``chip_smoke.py``'s ``distributed`` phase (a gloo
  group of one rank, reduced qwen3-8b, small collective shapes): every
  gate passes."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, train

CASES = [("qwen3-8b", "w8a8"), ("qwen3-8b", "w8a8_kernel"),
         ("granite-moe-1b-a400m", "w8a8_kernel"), ("mamba2-1.3b", "w8a8")]
BATCH, PROMPT, NEW = 4, 32, 6


def _plan(name):
    from repro_torch.core import backend as backend_lib
    from repro_torch.models import model as M
    # The deploy plan (routers exact) with every other linear on `name`.
    return backend_lib.DeploymentPlan(rules=M.DEFAULT_DEPLOY_PLAN.rules,
                                      default=name)


def _serve(arch, plan_name, mesh=None):
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.serve import prng

    cfg = configs.reduced_config(arch)
    plan = _plan(plan_name)
    params = M.freeze_params(
        M.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
        a_scale=0.05, plan=plan)
    if mesh is not None:
        params = sharding.distribute(params, sharding.resolve_param_specs(
            M.freeze_pspec(M.pspec(cfg), plan=plan), mesh))
    prompts = prng.randint(prng.PRNGKey(1), (BATCH, PROMPT), 0, cfg.vocab)
    return serve.static_generate(params, cfg, prompts, NEW,
                                 max_len=PROMPT + NEW + 8, plan=plan,
                                 mesh=mesh)


def _serve_rank(rank):
    from repro_torch.distributed import spmd
    from repro_torch.models import model as M

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    out = {}
    for arch, plan in CASES:
        tokens, logits = _serve(arch, plan, mesh)
        out[(arch, plan)] = (tokens.numpy(), logits.numpy())
    # The localized tree: column-parallel linears and expert banks keep
    # their model shard, row-parallel ones are whole.
    cfg = configs.reduced_config("granite-moe-1b-a400m")
    from repro_torch.distributed import sharding
    params = sharding.distribute(
        M.freeze_params(M.init(cfg, torch.Generator().manual_seed(0),
                               device="cpu"), a_scale=0.05),
        sharding.resolve_param_specs(M.freeze_pspec(M.pspec(cfg)), mesh))
    blk = spmd.localize(params)["stack"]["blocks"][0]
    out["layout"] = (
        isinstance(blk["attn"]["q"], spmd.ColumnShard)
        and blk["attn"]["q"]["w_q"].shape == (64, 32)
        and not isinstance(blk["attn"]["o"], spmd.ColumnShard)
        and blk["attn"]["o"]["w_q"].shape == (64, 64)
        and isinstance(blk["moe"], spmd.ExpertShard)
        and blk["moe"]["gate_q"].shape == (4, 64, 32)
        and blk["moe"].lo == 4 * mesh.get_local_rank("model"))
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    return mesh_lib.spawn(_serve_rank, 4, device="cpu", timeout_s=150,
                          threads=1)


@pytest.mark.parametrize("arch,plan", CASES)
def test_mesh_static_serve_equals_one_device(mesh_runs, arch, plan):
    tokens, logits = _serve(arch, plan)
    for r in mesh_runs:
        got_tokens, got_logits = r[(arch, plan)]
        assert torch.equal(torch.from_numpy(got_tokens), tokens)
        assert torch.equal(torch.from_numpy(got_logits), logits)


def test_localized_layout(mesh_runs):
    assert all(r["layout"] for r in mesh_runs)


def test_serve_launcher_on_two_ranks():
    args = ["--arch", "qwen3-8b", "--device", "cpu", "--quant", "w8a8",
            "--batch", "4", "--tokens", "4"]
    one = serve.main(args)
    two = serve.main(args + ["--devices", "2", "--mesh-shape", "1,2"])
    assert torch.equal(torch.as_tensor(two), one)


def test_train_launcher_on_two_ranks_resumes_onto_another_mesh(tmp_path):
    args = ["--arch", "granite-moe-1b-a400m", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--devices", "2"]
    first = train.main(args + ["--steps", "3", "--mesh-shape", "1,2"])
    assert first["start"] == 0 and len(first["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    again = train.main(args + ["--steps", "4", "--mesh-shape", "2,1"])
    assert again["start"] == 3 and [h["step"] for h in again["history"]] \
        == [3]
    assert np.isfinite(again["history"][0]["loss"])


def test_cuda_ranks_beyond_the_cards_raise():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, have + 1)
    with pytest.raises(RuntimeError, match=f"--devices {n} needs {n} CUDA "
                       f"devices .* {have} are visible"):
        serve.main(["--arch", "qwen3-8b", "--devices", str(n),
                    "--mesh-shape", f"1,{n}"])
    with pytest.raises(RuntimeError, match=f"{have} are visible"):
        train.main(["--arch", "qwen3-8b", "--devices", str(n),
                    "--mesh-shape", f"{n},1"])
    with pytest.raises(ValueError, match="mesh-shape 2,2 has 4 devices"):
        serve.main(["--arch", "qwen3-8b", "--device", "cpu", "--devices",
                    "2", "--mesh-shape", "2,2"])


def test_torchrun_ranks_across_nodes_check_this_nodes_cards(monkeypatch):
    """Under a two-node torchrun (16 ranks, 8 a node) each node needs 8
    cards, not 16."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in {"RANK": "9", "LOCAL_RANK": "1", "WORLD_SIZE": "16",
                 "LOCAL_WORLD_SIZE": "8"}.items():
        monkeypatch.setenv(k, v)
    assert mesh_lib.local_ranks(16) == 8
    mesh_lib.check_devices(16, "cuda")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "12")
    with pytest.raises(RuntimeError, match="--devices 16 puts 12 of its "
                       "ranks on this node.* 8 are visible"):
        mesh_lib.check_devices(16, "cuda")
    with pytest.raises(RuntimeError, match="--devices 16 needs 16 CUDA "
                       "devices"):
        mesh_lib.check_devices(16, "cuda", local=16)
    # Without a launcher's environment the port spawns every rank here.
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k)
    assert mesh_lib.local_ranks(16) == 16


def test_distributed_phase_rehearsal(monkeypatch):
    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    monkeypatch.setattr(chip_smoke, "DIST_ATTN", (2, 8, 4, 16, 64, 49))
    monkeypatch.setattr(chip_smoke, "DIST_PSUM_ELEMS", 4096)
    cfg = dataclasses.replace(configs.reduced_config("qwen3-8b"),
                              kv_cache_dtype="int8")
    result, launches, failures = chip_smoke.distributed_path(
        torch, cfg, cim_ops, paged_ops, device="cpu", cache={})
    assert failures == [] and result["ok"]
    assert result["serve"]["tokens_equal"]
    assert result["serve"]["prefill_logits_bit_identical"]
    assert not torch.distributed.is_initialized()
