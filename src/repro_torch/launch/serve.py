"""Serving launcher of the PyTorch port: ``repro/launch/serve.py`` with
the same flags, plus ``--device``.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-8b --plan w8a8_kernel \\
      --batch 8 --tokens 16 [--device cpu]
  python -m repro_torch.launch.serve --arch qwen3-8b --continuous \\
      [--chunked-prefill] --paged-attn --plan w8a8_kernel \\
      --batch 16 --max-batch 8 --kv-blocks 128 --segment-len 8 [--device cpu]

Like the JAX launcher it serves the arch's reduced config with random
weights (seeded).  Without ``--continuous`` it is the static engine:
``--batch`` prompts of ``--prompt-len`` tokens drawn from
``PRNGKey(1)`` (``serve/prng.py``, the JAX launcher's prompts), one
prefill and greedy decode on one device.  ``--continuous`` serves a
synthetic Poisson request stream with blocking prefill, or chunked
prefill with ``--chunked-prefill``.  Flags whose features are not ported
yet (more than one device, ``--mesh-shape``, page-out preemption, the
prefix cache, snapshots, drain/restore) raise ``NotImplementedError``.
"""
import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--mesh-shape", default=None)
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

    later = "is not ported yet (ROADMAP queue 1)"
    if args.devices not in (None, 1):
        raise NotImplementedError(f"--devices {args.devices}: more than one "
                                  f"device {later}")
    for flag, value in (("--mesh-shape", args.mesh_shape),
                        ("--drain-deadline", args.drain_deadline),
                        ("--restore", args.restore)):
        if value is not None:
            raise NotImplementedError(f"{flag} {later}")

    from repro_torch import configs as cfg_lib
    from repro_torch import device as device_lib
    from repro_torch.core import backend as backend_lib
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, Request, RequestStatus

    dev = device_lib.resolve(args.device)
    cfg = cfg_lib.reduced_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(cfg, gen, device=dev)
    plan = None
    if args.plan is not None:
        plan = backend_lib.load_plan(args.plan)
    elif args.quant == "w8a8":
        plan = M.DEFAULT_DEPLOY_PLAN
    if plan is not None:
        params = M.freeze_params(params, a_scale=0.05, plan=plan)
    tag = "plan" if args.plan is not None else args.quant
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
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.poisson(2.0, size=args.batch))
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                    max_new=args.tokens, arrival_step=int(t),
                    deadline_steps=args.deadline_steps)
            for i, t in enumerate(arrivals)]
    t0 = time.perf_counter()
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
    print(f"[{tag}|continuous|{attn}|{pf}|"
          f"preemption:{args.preemption}|{ce.device}] served {len(reqs)} "
          f"requests / {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s "
          f"incl. warm-up); {ce.last_run_segments} segments, "
          f"{ce.last_run_dispatches} dispatches, {ce.last_run_host_syncs} "
          f"host syncs, {ce.last_run_defrags} defrags, {n_ok}/{len(reqs)} "
          f"OK ({ce.last_run_preemptions} preempts, "
          f"{ce.last_run_recomputes} recomputes, {ce.last_run_sheds} shed, "
          f"{ce.last_run_timeouts} timeout), p50 latency "
          f"{lat[len(lat) // 2]} steps, TTFT p99 "
          f"{ce.ttft_percentile(99) * 1e3:.1f}ms")
    if args.metrics_out:
        ce.export_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        ce.export_trace(args.trace_out)
        print(f"trace -> {args.trace_out}")
    return res


def _static(args, cfg, params, plan, dev, tag):
    """The static engine on one device: prefill the prompt batch, then
    greedy decode, as the JAX launcher's mesh path does.  Returns the
    generated tokens ``[batch, tokens]``."""
    from repro_torch.models import model as M
    from repro_torch.serve import prng

    max_len = args.prompt_len + args.tokens + 8
    prompts = prng.randint(prng.PRNGKey(1, device=dev),
                           (args.batch, args.prompt_len), 0, cfg.vocab)
    t0 = time.perf_counter()
    logits, caches = M.prefill(params, {"tokens": prompts.long()}, cfg,
                               max_len=max_len, mode=plan)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    for _ in range(args.tokens - 1):
        logits, caches = M.decode_step(params, {"tokens": tok[:, None]},
                                       caches, cfg, mode=plan)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
    tokens = torch.stack(out, dim=1).to(torch.int32).cpu()
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    print(f"[{tag}] served {total} tokens on 1 devices ({dev}) in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s incl. warm-up)")
    return tokens


if __name__ == "__main__":
    main()
