"""Dry run of the port: trace every (arch x shape x mesh) cell (port of
``repro/launch/dryrun.py``).

For each cell this builds the REAL step of its kind (the full train step
with AdamW state, or the serving prefill / decode step) on rank 0 of the
production mesh, over a fake process group of 256 or 512 ranks
(``launch.mesh.make_fake_production_mesh``), with fake tensors
(``FakeTensorMode``: nothing is allocated, on the card or off it), runs
it once and records:

  * memory: this rank's argument bytes (its shards of the params, the
    optimizer state, the batch and the caches), its output bytes, and the
    peak of what the step allocates (``temp_bytes``, counted by
    ``roofline.op_count.OpCounter``);
  * per-device flops and traffic bytes, and the collectives
    (``roofline.op_count.OpCounter``; JAX reads them from optimized HLO);
  * the hand-written kernels' records under the ``port`` key (K1 on
    every linear under ``--quant w8a8``).

The cell's JSON has the JAX package's keys (``lower_s`` is the build's
seconds, ``compile_s`` the trace's; ``xla_cost_*`` repeat the counter's
figures, which are loop-aware already) and one more, ``port``.  The step
is the port's mesh step: the params rest as DTensors and the model
gathers them one block at a time where it runs the block
(``spmd.gather_block``; a train step reduce-scatters each block's
gradients in its backward); a decode cell's caches are this rank's
shards as ``sharding.cache_specs`` lays them out (``spmd.split_caches``:
the KV sequence over 'model', SSM states by heads), as the JAX package's
dry run lays them out, and ``--no-seq-shard`` lays them out with
``seq_shard=False`` (``port.cache_seq_shard`` says which).
``--act-shard`` stores the residual stream d-sharded over 'model'
between dense blocks, as the JAX package's ``dense_block`` does (one
all-gather a block).  ``--quant w8a8`` deploys every
linear but the routers on K1 (``w8a8_kernel``), as the JAX package's
``w8a8`` deploys them on its fused kernel.

``--device cuda`` (the default) traces the card's path on fake CUDA
tensors, which needs PyTorch built with CUDA; ``--device cpu`` traces the
CPU path.  A data-dependent op (``.item()``, ``nonzero``) on a fake
tensor fails the cell with its reason.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
Each --all cell runs in a subprocess (a process holds one process group).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch import configs as cfg_lib
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core import backend as backend_lib
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed import spmd
from repro_torch.models import model as model_lib
from repro_torch.roofline import op_count
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_loop import make_train_step

# --quant w8a8: every linear on K1, the MoE routers in float.
QUANT_PLAN = backend_lib.DeploymentPlan(
    rules=(("*router*", backend_lib.LayerRule("exact")),),
    default="w8a8_kernel")


@dataclasses.dataclass
class Cell:
    """One built cell: ``step()`` runs rank 0's step; ``arguments`` are
    this rank's argument tensors (for their bytes)."""

    step: object
    arguments: list
    # Bytes this rank holds beyond the JAX package's layout (its caches
    # laid out with seq_shard=False, where JAX splits them over 'model').
    over_jax_layout: int = 0
    # Whether the decode caches are split over sequence (cache_specs'
    # seq_shard=True layout).
    seq_shard: bool = False


def check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda traces the card's path on fake CUDA tensors and "
            "needs PyTorch with CUDA; pass --device cpu to trace the CPU "
            "path")
    return dev


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (a DTensor's
    local shard)."""
    seen, total = set(), 0
    for t in opt_lib.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, shard_lib.DTensor):
            t = t.to_local()
        key = (t.untyped_storage()._cdata, t.storage_offset())
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def shard_bytes(tree, shardings) -> int:
    """Bytes one rank holds of ``tree`` laid out by ``shardings`` (a tree
    of ``sharding.NamedSharding``): per dim the size over its mesh axes,
    rounded up (rank 0's shard of an uneven split, as JAX pads it)."""
    total = 0
    for t, sh in zip(opt_lib.tree_leaves(tree),
                     opt_lib.tree_leaves(shardings)):
        sizes = dict(zip(sh.mesh.mesh_dim_names, tuple(sh.mesh.shape)))
        n = t.element_size()
        for d, ax in zip(t.shape, tuple(sh.spec) + (None,) * t.ndim):
            axes = () if ax is None else ((ax,) if isinstance(ax, str)
                                          else tuple(ax))
            k = 1
            for a in axes:
                k *= sizes[a]
            n *= -(-d // k)
        total += n
    return total


def _on(tree, dev: torch.device):
    """Each tensor of ``tree`` as an empty one of its shape, strides and
    dtype on ``dev`` (fake CUDA leaves from fake CPU ones: a CPU build of
    PyTorch cannot ``.to`` a fake tensor to CUDA)."""
    if dev.type == "cpu":
        return tree
    return opt_lib.tree_map(
        lambda x: torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                      device=dev)
        if isinstance(x, torch.Tensor) else x, tree)


def fake_params(cfg, dev, plan=None, frozen=False):
    """``model.init``'s params (seed 0) made on the CPU under the running
    FakeTensorMode, moved to ``dev`` and frozen by ``plan`` when
    ``frozen``."""
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    params = _on(params, dev)
    if frozen:
        params = model_lib.freeze_params(params, plan=plan)
    return params


def micro_batches(cfg, shape, mesh) -> int:
    """JAX's automatic gradient accumulation: the remat carry stack [L,
    B_mb, S, d] must fit ~4 GiB a device (bf16), in an even split of the
    data ranks' rows."""
    names = tuple(mesh.mesh_dim_names)
    dp = mesh.size() // mesh.shape[names.index("model")]
    carry = 2.0 * cfg.n_layers * shape.global_batch * shape.seq_len \
        * cfg.d_model
    micro = max(1, int(-(-carry // (4 * 2**30 * dp))))
    max_micro = max(1, shape.global_batch // dp)
    micro = min(micro, max_micro)
    while max_micro % micro:   # keep the microbatch split even
        micro += 1
    return micro


def _on_mesh(step, mesh):
    """``step`` run inside one ``spmd.scope(mesh)``, re-entered at each
    call, so the model's gather plans carry over from call to call as
    within a serving call; ``step`` itself without a mesh."""
    if mesh is None:
        return step
    with spmd.scope(mesh):
        return spmd.bind_scope(step)


def decode_step_fn(cfg, mode, mesh):
    """The port's mesh serve decode step: ``model.decode_step`` on this
    rank's rows (and its cache shards)."""
    def step(params, batch, caches):
        return model_lib.decode_step(params, batch, caches, cfg, mode=mode)
    return _on_mesh(step, mesh)


def prefill_step_fn(cfg, max_len: int, mode, mesh):
    """The port's mesh serve prefill: ``model.prefill`` of this rank's
    rows into fresh caches."""
    def step(params, batch):
        return model_lib.prefill(params, batch, cfg, max_len=max_len,
                                 mode=mode)
    return _on_mesh(step, mesh)


def build_cell(arch: str, shape_name: str, mesh, *, quant: str = "none",
               plan=None, remat_policy: str = "nothing",
               seq_shard: bool = True, kv_quant: bool = False,
               ssd_chunk: int = 0, capacity_factor: float = 0.0,
               act_shard: bool = False, device="cuda"):
    """Returns (cell, meta) for one cell, ``cell`` None when the cell is
    skipped.  Call it under a FakeTensorMode (``run_cell`` does)."""
    dev = torch.device(device)
    cfg = cfg_lib.get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if act_shard:
        cfg = dataclasses.replace(cfg, act_shard=True)
    if ssd_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssd_chunk))
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=capacity_factor))
    shape = SHAPES[shape_name]
    ok, reason = cfg_lib.cell_is_runnable(cfg, shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "quant": quant,
                      "skipped": reason}

    frozen = quant == "w8a8" or plan is not None
    deploy_plan = (plan if plan is not None else QUANT_PLAN) if frozen \
        else None
    pspec = model_lib.pspec(cfg)
    if frozen:
        pspec = model_lib.freeze_pspec(pspec, plan=deploy_plan)
    param_sh = shard_lib.resolve_param_specs(pspec, mesh)
    params = fake_params(cfg, dev, deploy_plan, frozen)

    meta = {
        "arch": arch, "shape": shape_name, "quant": quant,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind,
    }

    if shape.kind == "train":
        micro = micro_batches(cfg, shape, mesh)
        tcfg = TrainConfig(remat=True, microbatches=micro,
                           remat_policy=remat_policy)
        opt = opt_lib.init_opt_state(params)
        opt_sh = {"master": param_sh, "m": param_sh, "v": param_sh}
        params = shard_lib.distribute(params, param_sh)
        opt = {**{k: shard_lib.distribute(opt[k], opt_sh[k])
                  for k in opt_sh}, "step": opt["step"]}
        batch = cfg_lib.input_specs(cfg, shape, device=dev)
        step = make_train_step(cfg, tcfg, plan=deploy_plan, mesh=mesh)
        meta["microbatches"] = micro
        local = spmd.local_batch(batch, mesh)
        return Cell(lambda: step(params, opt, batch),
                    [params, opt, local]), meta

    params = shard_lib.distribute(params, param_sh)
    if shape.kind == "prefill":
        batch = spmd.local_batch(cfg_lib.input_specs(cfg, shape, device=dev),
                                 mesh)
        step = prefill_step_fn(cfg, shape.seq_len, deploy_plan, mesh)
        return Cell(lambda: step(params, batch), [params, batch]), meta

    # decode: this rank's shards of the caches as cache_specs lays them
    # out (its batch rows; the KV sequence over 'model' with seq_shard).
    dp = shard_lib._prod_axis(mesh, shard_lib.batch_axes(mesh))
    b = shape.global_batch
    rows = b // dp if b % dp == 0 else b
    specs = cfg_lib.decode_input_specs(cfg, shape, batch=rows, device=dev)
    batch = specs["batch"]
    caches = spmd.split_caches(specs["caches"], mesh, cfg,
                               seq_shard=seq_shard)
    del specs
    # The JAX package's caches: batch over data, sequence over 'model'.
    full = cfg_lib.decode_input_specs(cfg, shape, device=dev)["caches"]
    jax_caches = shard_bytes(full, shard_lib.cache_specs(
        mesh, full, cfg, b, seq_shard=True))
    step = decode_step_fn(cfg, deploy_plan, mesh)
    return Cell(lambda: step(params, batch, caches), [params, batch, caches],
                tensor_bytes(caches) - jax_caches, seq_shard), meta


def trace(step) -> dict:
    """Run ``step()`` once under the counter:
    ``{"agg": OpCounter.aggregate(), "out": the step's outputs,
    "temp_bytes": peak bytes it allocated, "seconds"}``.  A data-dependent
    op on a fake tensor raises naming its op."""
    from torch._subclasses import fake_tensor
    counter = op_count.OpCounter()
    t0 = time.perf_counter()
    try:
        with counter:
            out = step()
    except (fake_tensor.DataDependentOutputException,
            fake_tensor.DynamicOutputShapeException) as e:
        raise RuntimeError(f"data-dependent op in the traced step: {e!r} "
                           "(a fake tensor has no values)") from e
    return {"agg": counter.aggregate(), "out": out,
            "temp_bytes": counter.peak_bytes(),
            "seconds": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             quant: str = "none", plan=None, out_json: str | None = None,
             seq_shard: bool = True, remat_policy: str = "nothing",
             kv_quant: bool = False, ssd_chunk: int = 0,
             capacity_factor: float = 0.0, act_shard: bool = False,
             device="cuda", mesh=None) -> dict:
    """Build and trace one cell on rank 0 of the production mesh (a fake
    group this call starts; ``mesh``, a DeviceMesh over a running group,
    replaces it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import mesh as mesh_lib
    dev = check_device(device)
    if mesh is None:
        mesh = mesh_lib.make_fake_production_mesh(
            multi_pod=(mesh_kind == "multi"), device=dev.type)
        try:
            return run_cell(arch, shape_name, mesh_kind, quant=quant,
                            plan=plan, out_json=out_json,
                            seq_shard=seq_shard, remat_policy=remat_policy,
                            kv_quant=kv_quant, ssd_chunk=ssd_chunk,
                            capacity_factor=capacity_factor,
                            act_shard=act_shard, device=device, mesh=mesh)
        finally:
            torch.distributed.destroy_process_group()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell, meta = build_cell(arch, shape_name, mesh, quant=quant,
                                plan=plan, seq_shard=seq_shard,
                                remat_policy=remat_policy, kv_quant=kv_quant,
                                ssd_chunk=ssd_chunk,
                                capacity_factor=capacity_factor,
                                act_shard=act_shard, device=dev)
        meta["mesh"] = mesh_kind
        meta["kv_quant"] = kv_quant
        if cell is None:
            result = {**meta, "status": "skipped"}
        else:
            t_lower = time.time() - t0
            arg_bytes = tensor_bytes(cell.arguments)
            tr = trace(cell.step)
            t_compile = time.time() - t0 - t_lower
            agg = tr["agg"]
            n_chips = mesh.size()
            result = {
                **meta,
                "status": "ok",
                "lower_s": round(t_lower, 1),
                "compile_s": round(t_compile, 1),
                "n_chips": n_chips,
                "flops_per_device": agg["flops"],
                "traffic_bytes_per_device": agg["traffic_bytes"],
                "unknown_trip_loops": agg["unknown_trip_loops"],
                "top_ops": agg["top_ops"],
                "xla_cost_flops": agg["flops"],
                "xla_cost_bytes": agg["traffic_bytes"],
                "memory": {
                    "argument_bytes": arg_bytes,
                    "output_bytes": tensor_bytes(tr["out"]),
                    "temp_bytes": tr["temp_bytes"],
                },
                "collectives": agg["collectives"],
                "port": {
                    "device": dev.type,
                    "kernels": agg["kernels"],
                    "cache_seq_shard": cell.seq_shard,
                    "jax_layout_argument_bytes":
                        arg_bytes - cell.over_jax_layout,
                    "trace_s": tr["seconds"],
                },
            }
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} "
                  f"quant={quant}: traced in {tr['seconds']:.1f}s; "
                  f"flops/dev={result['flops_per_device']:.3e} "
                  f"temp={result['memory']['temp_bytes']/2**30:.2f}GiB "
                  f"coll={sum(c['wire_bytes'] for c in agg['collectives'].values()):.3e}B "
                  f"K1={agg['kernels'].get('cim_matmul', {}).get('records', 0)}")
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--quant", default="none", choices=["none", "w8a8"])
    ap.add_argument("--plan", default=None,
                    help="DeploymentPlan: backend name, inline JSON, or path")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable KV sequence sharding: a decode cell's "
                         "caches split over batch only (cache_specs' "
                         "seq_shard=False)")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode shapes)")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--act-shard", action="store_true",
                    help="d_model-sharded residual stream between "
                         "dense blocks")
    ap.add_argument("--cf", type=float, default=0.0,
                    help="MoE capacity factor override")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) via subprocesses")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--cell-timeout", type=float, default=2400.0)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="trace the card's path (fake CUDA tensors) or the "
                         "CPU path")
    args = ap.parse_args(argv)
    check_device(args.device)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        # Worklist: cheap kinds first (decode < prefill < train), small archs
        # before qwen2-vl-72b, single mesh before multi — so partial sweeps
        # maximize coverage.
        size_order = sorted(
            cfg_lib.ARCH_IDS, key=lambda a: cfg_lib.get_config(a).param_count())
        kind_rank = {"decode": 0, "prefill": 1, "train": 2}
        work = []
        for mesh_kind in meshes:
            for shape_name in sorted(
                    SHAPES, key=lambda s: kind_rank[SHAPES[s].kind]):
                for arch in size_order:
                    work.append((arch, shape_name, mesh_kind))
        work.sort(key=lambda w: (w[2] == "multi",
                                 kind_rank[SHAPES[w[1]].kind]))

        def launch(item):
            arch, shape_name, mesh_kind = item
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", mesh_kind, "--quant", args.quant,
                   "--out", args.out, "--device", args.device]
            return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        failures, running, idx = [], [], 0
        t_start = time.time()
        while idx < len(work) or running:
            while idx < len(work) and len(running) < args.jobs:
                arch, shape_name, mesh_kind = work[idx]
                tag = f"{arch}__{shape_name}__{mesh_kind}__{args.quant}"
                out = os.path.join(args.out, tag + ".json")
                if os.path.exists(out):
                    print(f"[dryrun] {tag}: cached")
                    idx += 1
                    continue
                running.append((work[idx], launch(work[idx]), time.time()))
                idx += 1
            still = []
            for item, proc, t0 in running:
                if proc.poll() is None:
                    if time.time() - t0 > args.cell_timeout:
                        proc.kill()
                        proc.communicate()
                        failures.append(("timeout", item))
                        print(f"[dryrun] TIMEOUT {item}")
                    else:
                        still.append((item, proc, t0))
                else:
                    out_s, err_s = proc.communicate()
                    sys.stdout.write(out_s[-1500:])
                    print(f"[dryrun] {'__'.join(item)}: "
                          f"{time.time() - t0:.1f}s")
                    sys.stdout.flush()
                    if proc.returncode != 0:
                        failures.append(("error", item))
                        sys.stderr.write(err_s[-3000:])
            running = still
            time.sleep(0.2)
        print(f"[dryrun] sweep done in {(time.time()-t_start)/60:.1f} min; "
              f"failures: {failures}")
        if failures:
            sys.exit(1)
        return

    assert args.arch and args.shape, "--arch/--shape or --all required"
    for mesh_kind in meshes:
        tag = f"{args.arch}__{args.shape}__{mesh_kind}__{args.quant}" \
            + ("__kvq" if args.kv_quant else "") \
            + (f"__ssd{args.ssd_chunk}" if args.ssd_chunk else "") \
            + (f"__cf{args.cf}" if args.cf else "") \
            + (f"__remat-{args.remat_policy}" if args.remat_policy != "nothing" else "") \
            + ("__actshard" if args.act_shard else "")
        out_json = os.path.join(args.out, tag + ".json")
        plan = backend_lib.load_plan(args.plan) if args.plan else None
        run_cell(args.arch, args.shape, mesh_kind, quant=args.quant,
                 plan=plan,
                 out_json=out_json, seq_shard=not args.no_seq_shard,
                 remat_policy=args.remat_policy, kv_quant=args.kv_quant,
                 ssd_chunk=args.ssd_chunk, capacity_factor=args.cf,
                 act_shard=args.act_shard, device=args.device)


if __name__ == "__main__":
    main()
