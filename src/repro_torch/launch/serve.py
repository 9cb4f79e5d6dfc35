"""Serving launcher of the PyTorch port: ``repro/launch/serve.py`` with
the same flags, plus ``--device``.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-8b --plan w8a8_kernel \\
      --batch 8 --tokens 16 [--device cpu]
  python -m repro_torch.launch.serve --arch qwen3-8b --continuous \\
      [--chunked-prefill] --paged-attn --plan w8a8_kernel \\
      --batch 16 --max-batch 8 --kv-blocks 128 --segment-len 8 [--device cpu]
  python -m repro_torch.launch.serve --arch qwen3-8b --continuous \\
      --prefix-cache --preemption page_out --snapshot-dir DIR \\
      --drain-deadline 4 [--device cpu]
  python -m repro_torch.launch.serve --arch qwen3-8b --continuous \\
      --prefix-cache --preemption page_out \\
      --restore DIR/serve_snap.npz [--device cpu]

``--arch`` takes any of ``repro_torch.configs.ARCH_IDS`` (qwen3-8b,
deepseek-7b, stablelm-12b, h2o-danube-3-4b, granite-moe-1b-a400m,
moonshot-v1-16b-a3b, whisper-large-v3, qwen2-vl-72b, mamba2-1.3b,
zamba2-2.7b).  MoE, sliding-window, encoder-decoder, M-RoPE, ssm and
hybrid archs are served by the static engine only: ``--continuous``
refuses them with the JAX package's message.  The static engine feeds
token prompts only, as the JAX launcher does: qwen2-vl-72b serves them
text-only, and whisper-large-v3, whose encoder needs frame embeddings,
raises a ``ValueError`` naming ``frames``.  Like the JAX launcher it
serves the arch's reduced config with random weights (seeded).  Without
``--continuous`` it is the static engine: ``--batch`` prompts of
``--prompt-len`` tokens drawn from ``PRNGKey(1)`` (``prng.py``, the
JAX launcher's prompts), one prefill and greedy decode on one device
(or a mesh, below).  ``--continuous`` serves a
synthetic Poisson request stream with blocking prefill, or chunked
prefill with ``--chunked-prefill``; ``--prefix-cache`` gives 80% of the
requests a shared system prefix of half the prompt; ``--drain-deadline``
drains the run at its first completion into a final snapshot in
``--snapshot-dir``, and ``--restore`` serves what such a snapshot holds
in flight.

``--devices N --mesh-shape d,m`` (or ``p,d,m``) serves the static engine
on a DeviceMesh of N ranks (``launch/mesh.py``), as the JAX launcher's
pjit path: the (frozen) params are laid out by
``sharding.resolve_param_specs``, each rank prefills and greedy-decodes
its rows of the prompt batch with the column-parallel linears (q/k/v,
gate/up, in_proj, the head) on its own output columns -- under a
``w8a8_kernel`` plan K1 runs on its local shard -- and the row-parallel
ones gathered to their full K, one block at a time where the block runs
(``spmd.gather_block``; ``distributed/spmd.py``); each rank's caches
hold its rows over the whole sequence.  ``--quant
w8a8`` is ``M.DEFAULT_DEPLOY_PLAN``.  Without a launcher's ``RANK`` /
``WORLD_SIZE`` in the environment it starts the N ranks itself: gloo
ranks with ``--device cpu``, one CUDA card per rank otherwise (fewer
cards than N raises).  ``--continuous`` serves on one device, as in
JAX.
"""
import argparse
import contextlib
import os
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh (one card each on cuda)")
    ap.add_argument("--mesh-shape", default=None,
                    help="d,m or p,d,m (data, model[, pod]) mesh shape")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--quant", default="none", choices=["none", "w8a8"])
    ap.add_argument("--plan", default=None,
                    help="DeploymentPlan: backend name, inline JSON, or path")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--kv-blocks", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--segment-len", type=int, default=8)
    ap.add_argument("--paged-attn", action="store_true")
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--preemption", default="recompute",
                    choices=["off", "recompute", "page_out"])
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-interval", type=int, default=None)
    ap.add_argument("--drain-deadline", type=int, default=None)
    ap.add_argument("--restore", default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--deadline-steps", type=int, default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--no-telemetry", action="store_true")
    ap.add_argument("--profiler-annotations", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch import mesh as mesh_lib

    shape = n_dev = None
    if args.mesh_shape is not None or (args.devices or 1) > 1:
        shape, n_dev = mesh_lib.shape_and_count(args.mesh_shape,
                                                args.devices)
        if args.continuous:
            raise ValueError("--continuous serves on one device (as the "
                             "JAX launcher); drop --devices/--mesh-shape")
        if not torch.distributed.is_initialized():
            mesh_lib.check_devices(n_dev, args.device)
            if "WORLD_SIZE" not in os.environ:
                return mesh_lib.spawn(_rank_main, n_dev, device=args.device,
                                      args=(argv,))[0]
            mesh_lib.init_group(args.device)

    from repro_torch import configs as cfg_lib
    from repro_torch import device as device_lib
    from repro_torch.core import backend as backend_lib
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, Request, RequestStatus

    dev = device_lib.resolve(args.device)
    if dev.type == "cuda" and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cfg_lib.reduced_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(cfg, gen, device=dev)
    pspec = M.pspec(cfg)
    plan = None
    if args.plan is not None:
        plan = backend_lib.load_plan(args.plan)
    elif args.quant == "w8a8":
        plan = M.DEFAULT_DEPLOY_PLAN
    if plan is not None:
        params = M.freeze_params(params, a_scale=0.05, plan=plan)
        pspec = M.freeze_pspec(pspec, plan=plan)
    tag = "plan" if args.plan is not None else args.quant
    if shape is not None:
        from repro_torch.distributed import sharding
        mesh = mesh_lib.make_mesh(shape, device=dev.type)
        params = sharding.distribute(
            params, sharding.resolve_param_specs(pspec, mesh))
        return _static(args, cfg, params, plan, dev, tag, mesh=mesh)
    if not args.continuous:
        return _static(args, cfg, params, plan, dev, tag)

    ce = ContinuousEngine(
        params, cfg, plan=plan, max_batch=args.max_batch,
        kv_blocks=args.kv_blocks, block_size=args.block_size,
        segment_len=args.segment_len, paged_attn=args.paged_attn,
        chunked_prefill=args.chunked_prefill,
        prefill_chunk=args.prefill_chunk, preemption=args.preemption,
        max_queue=args.max_queue, prefix_cache=args.prefix_cache,
        snapshot_dir=args.snapshot_dir,
        snapshot_interval=args.snapshot_interval,
        telemetry=not args.no_telemetry,
        profiler_annotations=args.profiler_annotations, device=dev)
    t0 = time.perf_counter()
    if args.restore is not None:
        # Cold start from a checkpoint: serve whatever the snapshot holds
        # in flight to completion.
        res = ce.restore(args.restore).resume()
        reqs = list(res.values())
    else:
        reqs = _requests(args, cfg, Request)
        if args.drain_deadline is not None:
            # Graceful shutdown: latch the drain at the first completion;
            # stragglers land in the final snapshot (serve them later with
            # --restore).
            res, latched = {}, False
            for ev in ce.run_stream(reqs):
                if ev["event"] == "finish":
                    res[ev["rid"]] = ev["result"]
                    if not latched:
                        ce.drain(args.drain_deadline)
                        latched = True
            if not latched:
                raise SystemExit("--drain-deadline: no request finished "
                                 "before the drain could latch; raise "
                                 "--tokens")
        else:
            res = ce.run(reqs)
    if ce.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in res.values())
    n_ok = sum(r.status is RequestStatus.OK for r in res.values())
    lat = sorted(r.latency_steps for r in res.values()
                 if r.admitted_step >= 0) or [0]
    attn = "paged-attn" if args.paged_attn else "gather"
    pf = (f"chunked-prefill:{ce.prefill_chunk}" if args.chunked_prefill
          else "blocking-prefill")
    if args.prefix_cache:
        pf += "|prefix-cache"
    print(f"[{tag}|continuous|{attn}|{pf}|"
          f"preemption:{args.preemption}|{ce.device}] served {len(reqs)} "
          f"requests / {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s "
          f"incl. warm-up); {ce.last_run_segments} segments, "
          f"{ce.last_run_dispatches} dispatches, {ce.last_run_host_syncs} "
          f"host syncs, {ce.last_run_defrags} defrags, {n_ok}/{len(reqs)} "
          f"OK ({ce.last_run_preemptions} preempts, "
          f"{ce.last_run_recomputes} recomputes, {ce.last_run_spills} "
          f"spilled / {ce.last_run_restores} restored "
          f"({ce.last_run_spill_bytes} spill bytes), "
          f"{ce.last_run_snapshots} snapshots, {ce.last_run_recoveries} "
          f"recovered, {ce.last_run_sheds} shed, {ce.last_run_timeouts} "
          f"timeout), {ce.last_run_prefix_hits} prefix hits "
          f"({ce.last_run_prefix_hit_tokens} tok cached, "
          f"{ce.last_run_prefix_misses} misses, {ce.last_run_cow_copies} "
          f"CoW, {ce.last_run_suffix_prefills} suffix prefills), p50 "
          f"latency {lat[len(lat) // 2]} steps, TTFT p99 "
          f"{ce.ttft_percentile(99) * 1e3:.1f}ms")
    if ce.last_snapshot_path:
        print(f"snapshot -> {ce.last_snapshot_path}")
    if args.metrics_out:
        ce.export_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        ce.export_trace(args.trace_out)
        print(f"trace -> {args.trace_out}")
    return res


def _requests(args, cfg, request_cls):
    """The synthetic Poisson stream of the JAX launcher: ``--batch``
    requests from seed 0; with ``--prefix-cache`` 80% of them start with
    a shared system prefix of about half the prompt (whole blocks)."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.poisson(2.0, size=args.batch))
    sys_prefix = None
    if args.prefix_cache:
        n_sys = max(args.block_size,
                    (args.prompt_len // 2) // args.block_size
                    * args.block_size)
        sys_prefix = rng.integers(0, cfg.vocab, n_sys)
    reqs = []
    for i, t in enumerate(arrivals):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len)
        if sys_prefix is not None and rng.random() < 0.8:
            prompt = np.concatenate([sys_prefix,
                                     prompt[len(sys_prefix):]])
        reqs.append(request_cls(rid=i, prompt=prompt, max_new=args.tokens,
                                arrival_step=int(t),
                                deadline_steps=args.deadline_steps))
    return reqs


def _rank_main(rank, argv):
    """One rank of a spawned mesh run: ``main`` in the running group."""
    tokens = main(argv)
    return tokens.numpy() if rank == 0 else None


def static_generate(params, cfg, prompts, n_tokens: int, *, max_len: int,
                    plan=None, mesh=None) -> tuple:
    """Prefill ``prompts`` [B, S] and greedy-decode ``n_tokens`` tokens
    (the static engine of the launcher).  Returns (tokens [B, n_tokens]
    int64, the prefill's last-position logits [B, 1, V] f32), both for
    the whole batch.  With ``mesh`` the params are DTensors
    (``sharding.distribute``), gathered one block at a time where the
    model runs it, and each rank serves its rows of the batch
    (``distributed/spmd.py``); every rank returns the whole batch."""
    from repro_torch.distributed import spmd
    from repro_torch.models import model as M

    batch = {"tokens": prompts.long()}
    ctx = contextlib.nullcontext()
    if mesh is not None:
        batch = spmd.local_batch(batch, mesh)
        ctx = spmd.scope(mesh)
    with ctx:
        logits, caches = M.prefill(params, batch, cfg, max_len=max_len,
                                   mode=plan)
        first = logits
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, caches = M.decode_step(params, {"tokens": tok[:, None]},
                                           caches, cfg, mode=plan)
            tok = torch.argmax(logits[:, -1], dim=-1)
            out.append(tok)
    tokens = torch.stack(out, dim=1)
    if mesh is not None:
        rows = prompts.shape[0]
        tokens = spmd.gather_batch(tokens, mesh, global_rows=rows)
        first = spmd.gather_batch(first, mesh, global_rows=rows)
    return tokens, first


def _static(args, cfg, params, plan, dev, tag, mesh=None):
    """The static engine: prefill the prompt batch, then greedy decode, as
    the JAX launcher's mesh path does (on one device without ``mesh``).
    Returns the generated tokens ``[batch, tokens]``."""
    from repro_torch import prng

    max_len = args.prompt_len + args.tokens + 8
    prompts = prng.randint(prng.PRNGKey(1, device=dev),
                           (args.batch, args.prompt_len), 0, cfg.vocab)
    t0 = time.perf_counter()
    tokens, _ = static_generate(params, cfg, prompts, args.tokens,
                                max_len=max_len, plan=plan, mesh=mesh)
    tokens = tokens.to(torch.int32).cpu()
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    n = 1 if mesh is None else torch.distributed.get_world_size()
    if mesh is None or torch.distributed.get_rank() == 0:
        where = dev.type if mesh is None else f"{dev.type}, mesh " \
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        print(f"[{tag}] served {total} tokens on {n} devices ({where}) in "
              f"{dt:.2f}s ({total / dt:.1f} tok/s incl. warm-up)")
    return tokens


if __name__ == "__main__":
    main()
