"""Chip smoke test of the PyTorch + CUDA port on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. env      -- torch / CUDA / card, and the card's name and power limit.
2. build    -- compiles the five CUDA kernels from src/repro_torch/csrc,
               one nvcc per source, all started together.
3. kernels  -- holds each kernel against its plain PyTorch version on the
               card at its path's shapes (K1 at every serving (K, N) and
               M in K1_CASE_MS, and at VGG-8's ragged K = 27 and N = 10;
               K2 at one split and at the card's split count, then the
               decode merge; K4 at all 8 VGG-8 layer shapes and planes;
               K5 at conv2/conv6/fc1 with a sampled chip, codes equal to
               its plain version and within one code of the simulation)
               and times
               kernel, plain version, one PyTorch library call (the
               yardstick) and the bound (bytes / 3.35 TB/s or operations /
               the peak rate for the operand type, the larger).  K1 is
               timed at every serving (K, N) at M = 8 and 512 and K4 at
               every VGG-8 shape, each beside the byte-masked mma.sync
               kernel (the masked path, the previous design; in turns);
               K5 at every VGG-8 shape beside two library yardsticks
               (f32 torch.bmm, torch._int_mm) and the whole
               cim_macro_matmul call.  Then the model families'
               shapes (the ``kernel_family`` line): K1 bit-exact and timed
               at every deployed (K, N) of deepseek-7b, stablelm-12b,
               h2o-danube-3-4b, granite-moe-1b-a400m, moonshot-v1-16b-a3b,
               mamba2-1.3b, zamba2-2.7b, whisper-large-v3 and
               qwen2-vl-72b at M = 8 and 512 (and whisper's encoder M =
               1500 at its (1280, 1280) and (1280, 5120)); K2 and K3 at
               deepseek-7b's G = 1 and stablelm-12b's D = 160.
4. main     -- serves 8 requests through the port's ContinuousEngine at
               qwen3-8b's widths and SERVE_LAYERS = 12 of its 36 layers
               (main, static, blocking and durable share this model;
               w8a8_kernel plan, paged attention, chunked prefill, int8
               KV pool, random weights from a seed),
               checks every request is OK and every kernel launched,
               serves them once more with CUDA events around each kernel
               wrapper and the decode merge (device time by kernel, K1's
               split into decode and prefill calls, its own line), and
               replays the requests through the plain versions.
5. autotune -- the autotuner's measured table (kernels/autotune.py):
               every candidate config of K1 at qwen3-8b's (K, N) of q/o,
               k/v, gate/up and down, M = 8 and 512, int8 and f32 in,
               equal byte for byte to the heuristic config's, then timed
               (autotune.measure records the fastest); K2's split count
               (measure_paged, the best split held to 1e-3 of its plain
               version) and K3's chunk (measure_prefill) at the main
               phase's engine key; the table dumped to the build
               directory, cleared and loaded (every choice as measured);
               a ContinuousEngine at qwen3-8b's widths and 4 layers
               serving 4 of the main phase's prompts, 16 new, with no
               table, with the K1 entries only (streams identical) and
               with the whole table (the engine takes the loaded chunk
               and pages per split; streams identical where both are the
               heuristic's, else the main phase's logit gate).  The
               tables are cleared after it.
6. static   -- the static engine (Engine.generate over dense KV caches)
               on the same model (12 of 36 layers) and the same prompts,
               one call per prompt:
               greedy with the kernels (K1 must launch on every linear;
               prefill logits and first tokens gated as in main, against
               the plain versions' prefill), twice sampled with one key
               (identical streams); the
               sampler's random bits on the card equal the CPU's and its
               gumbel is within 2 ulp; decode-step and sampler times.
7. blocking -- the serving path with blocking prefill (the engine's
               default), paged attention, sampled at temperature 0.8:
               every request OK, K1 and K2 launched.
8. durable  -- the prefix cache, page-out preemption and drain/restore on
               the same model, greedy: 8 requests sharing a 256-token
               system prompt (two repeating another whole), uncached and
               cached, blocking and chunked (hits, copy-on-write copies,
               suffix prefills through K3; blocking first tokens gated by
               the main phase's logit rule, chunked streams equal, an
               exact-full-prompt hit's first token by the logit rule
               against the floor between the uncached chunks and a
               recompute of the last block);
               a page-out storm on a pool 8 blocks short (streams equal
               the unpressured run's); a drain into a snapshot in a
               temporary directory, restored into a fresh engine and
               resumed (streams equal the uninterrupted run's; snapshot
               bytes, save and restore seconds).  K3 is also held against
               its plain version at the suffix-prefill shapes in phase 3.
9. distributed -- the mesh paths at full width on an NCCL process group
               of one rank in a (1, 1) ("data", "model") DeviceMesh:
               qwen3-8b at all 36 layers (w8a8_kernel) through
               launch.serve.static_generate, 8 prompts of 32 tokens from
               PRNGKey(1), 16 new, greedy, without a mesh and with the
               params laid out as DTensors by resolve_param_specs and
               gathered one block at a time where the model runs it
               (tokens equal, prefill logits bit-identical, K1 launch
               counts equal; tok/s, decode step as the median of
               DIST_TURNS turns, distribute seconds);
               seq_parallel_decode_attention at qwen3-8b's
               decode shape (B 8, H 32, KVH 8, D 128, S 4096, 3001 valid)
               within 1e-5 of attend_decode; compressed_psum on a 16M
               gradient equal to its plain codec; pipeline_forward with
               one stage equal to the stage; K1 bit-exact and timed at
               the column shards of qwen3-8b's q, k/v, gate/up and head at
               a model axis of 16 (N 256, 64, 768, 9504; M 8 and 512)
               beside its plain version, bound and torch._int_mm.
10. dryrun   -- the port's dry run (launch/dryrun.py): qwen3-8b x
               decode_32k x w8a8 (all 36 layers), granite-moe-1b-a400m
               x train_4k x none (12 of its 24 layers, to keep the phase
               in its 90 s) and qwen3-8b x train_4k x none (4 of its 36
               layers) with and without --act-shard, traced on fake CUDA
               tensors on rank 0 of the 16 x 16 production mesh over a
               fake 256-rank group, one child process each, all started
               at the phase's start (JAX's keys; K1 recorded 36 x 7 + 1
               times per decode step; a decode cell's argument bytes,
               its caches split over sequence, equal to JAX's layout's,
               printed beside the constant figures of the whole-sequence
               layout; the decode temp within 5 % (or 64 MiB) of its CPU
               trace's; --act-shard's temp lower by the blocks' remat
               carries' 15/16, flops equal); while
               they run, the distributed phase's qwen3-8b (36 layers) at
               decode 8 x 4096
               and prefill 4 x 2048 on the card through the mesh path on
               an NCCL group of one rank (params gathered per block, the
               decode caches split by cache_specs), traced and run for
               real under one counter: flops, traffic and K1 records
               equal, K1's launches equal its records, the trace's peak
               within 5 % (or 64 MiB) of the real step's
               max_memory_allocated delta; step ms beside the roofline
               bound (repro_torch.roofline).
11. families -- the rest of the decoder-only family at published widths
               (depth cut where noted on each run's line), random weights
               from seed 0 frozen under w8a8_kernel (routers float),
               greedy: moonshot-v1-16b-a3b (4 of 48 layers) and
               granite-moe-1b-a400m (8 of 24) through Engine.generate, 4
               prompts of 64-512 tokens, 16 new (the 512-token prefill
               drops tokens at capacity); h2o-danube-3-4b (8 of 24) with
               its bf16 ring cache, one 4608-token prompt, 32 new;
               deepseek-7b and stablelm-12b (4 of 30 / 40 layers) through
               the ContinuousEngine (chunked prefill 64, paged attention,
               int8 pool, the main phase's 8 prompts, 16 new), and
               stablelm-12b once more through Engine.generate with a
               2560-token prompt (attend_chunked); the state-space
               families through Engine.generate, 32 new: mamba2-1.3b (12
               of 48 SSM layers) and zamba2-2.7b (12 of 54 SSM layers and
               the shared attention block over 2 int8 KV caches), each
               with prompts of 64, 192, 512 and 1024 tokens, a batch of
               four 512-token prompts and one 4096-token prompt (16 SSD
               chunks), and one profiler pass over mamba2's decode steps;
               the multimodal families through Engine.generate:
               whisper-large-v3 (all 32 encoder, 8 of 32 decoder layers) over
               1500 seeded bf16 frames (30 s of audio) under 4- and
               64-token decoder prompts at batch 1 and 4, 32 new, an int8
               self-attention cache beside bf16 cross K/V; qwen2-vl-72b
               (8 of 80 layers, or the depth the card's free memory holds,
               stated on its line) from seeded bf16 embeddings with
               Qwen2-VL's [3, B, S] positions: 64 text tokens, 16 + a
               16 x 16 image grid + 16, 64 + a 48 x 48 grid + 192 (2560,
               attend_chunked), 16 new.
               Each run: every request OK, K1 launched exactly (stack
               passes) x (its per-pass count: layers x per-layer count,
               the shared block's 7 a group, the head) + whisper's
               encoder passes x 192 and cross K/V projections x 2L,
               K2/K3 on the continuous runs, prefill logits within 1.5x
               the reordering floor (bit-identical to the plain versions'
               on the state-space and multimodal runs); the multimodal
               runs' first-token logits move with whisper's frames and
               with qwen2-vl's image positions; tokens per wall second,
               decode-step ms, peak memory.
12. train   -- in a child process with CUBLAS_WORKSPACE_CONFIG set (so
               cuBLAS is deterministic there and as before elsewhere):
               granite-moe-1b-a400m at its published size (24 layers,
               ~1.385 B parameters, bf16) trained under the qat plan with
               AdamW from model.init at seed 0, every block
               rematerialized, deterministic algorithms, no TF32: 8 steps
               on one fixed 8 x 256-token batch (every loss and grad norm
               finite and above 0, the loss falling), then 2 steps under
               the profiler (busy share); step ms, tokens per second,
               peak memory.  The trained model, optimizer state freed,
               frozen block by block under w8a8_kernel (routers float)
               and served through Engine.generate (4 prompts of 64 and
               128 tokens, 16 new): every request OK, K1 exactly stack
               passes x per-pass count, prefill logits within 1.5x the
               reordering floor.  Then train_loop.run at full width and
               2 of 24 layers, 6 steps straight against 3 and a resume
               to 6 in a temporary directory: params, m, v and losses
               bit-identical.  Then 2 qat steps at 2 layers without a
               mesh and on a (1, 1) mesh of an NCCL group of one rank
               (params, master, m, v as DTensors): params, m, v and
               losses bit-identical.
13. vgg8    -- the paper's VGG-8 deployment path (repro_torch.launch.fig10)
               at its published widths with random weights from a seed:
               w8a8_kernel (with and without residency) and
               bitserial_kernel logits bit-identical to their plain plans,
               the cim plan with 8 sampled chips, calibrated full scales
               and per-channel fine-tunes, and the CAAT macro op on every
               cim layer's int8 inputs against the behavioural simulation.
14. paper   -- the paper's own results through the port's entry points
               (repro_torch.launch), at the JAX package's keys: Fig. 7a,
               Fig. 7b (its measured negative fraction on the chip at
               PRNGKey(0)), Fig. 8, Table I and Fig. 9 (200 CAAT chips
               and 50 ADCs), every claim asserted as the JAX package's
               benchmarks assert it (the 65nm macro's model, not
               measurements); then Fig. 10 at JAX's sizes: VGG-8 trained
               100 Adam steps at batch 64 from PRNGKey(0), 192 eval
               images, exact / w8a8 (through K1: w8a8_kernel logits equal
               to the plain w8a8 plan's, K1 launched 8 times a batch of
               64) / cim raw / cim fine-tuned accuracies at 8 chips (cim
               at batch 32), JAX's two claims asserted.  One JSON line
               with every figure's values, the four accuracies, the
               phase's seconds by part and its peak memory.
15. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

``--skip-main`` stops after the kernel phase (a quick kernel check);
``--only families`` (comma-separated phase names, e.g. ``train``) runs
only the named serving phases after it, and ``--runs encdec,mrope`` only
the named runs of the families phase.
``--k5-only --src DIR`` only times the whole CAAT macro op at every VGG-8
shape, with the ``repro_torch`` package of another tree (a parent commit
unpacked beside this one; its chip is drawn at a key, so that tree needs
``repro_torch.prng`` and key-drawn chips).  Long output goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
K1_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
             (4096, 152064))       # (K, N) of q/o, k/v, gate/up, down, head
# (M, K, N) of VGG-8's eight layers at batch 32 (conv1 ... conv6, fc1,
# head): M is batch x pixels for a conv, K = 9 x C_in.
VGG8_SHAPES = ((32768, 27, 128), (32768, 1152, 128), (8192, 1152, 256),
               (8192, 2304, 256), (2048, 2304, 512), (2048, 4608, 512),
               (32, 8192, 1024), (32, 1024, 10))


def hw():
    """The card's memory rate and peak rates (``repro_torch.roofline.hw``,
    the port's one source for them), read once the package is on the
    path."""
    from repro_torch.roofline import hw as hw_lib
    return hw_lib


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def swapped(module, name: str, replacement):
    """Temporarily route ``module.name`` to ``replacement`` (a kernel
    wrapper to its plain twin; those calls are not counted as
    launches)."""
    saved = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def event_timed(torch, targets, tag=lambda: None):
    """Wrap each ``(module, name)`` function so that every call is
    bracketed by CUDA events on the current stream; yields ``{name: [(start,
    end, tag()), ...]}`` (read the times after a synchronize)."""
    events = {name: [] for _, name in targets}
    with contextlib.ExitStack() as stack:
        for module, name in targets:
            def timed(*a, _fn=getattr(module, name), _ev=events[name], **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*a, **k)
                end.record()
                _ev.append((start, end, tag()))
                return out
            stack.enter_context(swapped(module, name, timed))
        yield events


# Device kernels of the port by name, for the profiler's sums.
KERNEL_NAMES = (("cim_matmul", "cim_wgmma_kernel"),
                ("cim_matmul", "cim_matmul_kernel"),
                ("cim_quant_pass", "cim_quant_kernel"),
                ("paged_attention", "paged_decode_kernel"),
                ("merge_splits", "merge_splits_kernel"),
                ("flash_prefill", "prefill_"))


def device_time_by_kernel(prof, wall_s: float) -> dict:
    """Sum the profiler's device time by the port's kernels and the rest
    (PyTorch's own kernels, copies, fills); the busy share is all device
    time over the wall.  K1's wgmma kernel is also split by its token
    tile: decode tiles (8 or 16 tokens) and prefill tiles (64 or 128).
    Empty when the trace holds no device time."""
    sums: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if not us:
            continue
        name = next((k for k, pat in KERNEL_NAMES if pat in ev.key),
                    "other")
        entry = sums.setdefault(name, {"ms": 0.0, "calls": 0})
        entry["ms"] += us / 1e3
        entry["calls"] += ev.count
        tile = re.search(r"cim_wgmma_kernel<\d+, (\d+)", ev.key)
        if tile:
            kind = ("decode_tiles" if int(tile.group(1)) <= 16
                    else "prefill_tiles")
            sub = entry.setdefault("by_tile", {}).setdefault(
                kind, {"ms": 0.0, "calls": 0})
            sub["ms"] += us / 1e3
            sub["calls"] += ev.count
    busy = sum(e["ms"] for e in sums.values())
    for e in sums.values():
        e["share_of_wall"] = e["ms"] / (wall_s * 1e3)
    return {"by_kernel": sums, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3)} if sums else {}


def rand_i8(torch, shape, gen, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


def attention_peak(torch, dtype) -> float:
    """Peak rate for attention products on ``dtype`` operands.  The TPU
    kernels do them on the MXU, so the card's matching rate is its
    tensor-core rate for that type (bf16, or TF32 for f32)."""
    return (hw().PEAK_FLOPS_BF16 if dtype == torch.bfloat16
            else hw().PEAK_FLOPS_TF32)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / hw().HBM_BW
    t_ops = n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the main path reads each layer's weights and pages cold).  A
    device-side sleep after the flush keeps the card busy while the host
    enqueues the call, so the events time the device's work, not the
    wrapper's Python overhead on an idle card."""

    HIDE_CYCLES = 1_000_000     # ~0.5 ms of device sleep

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HIDE_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

# M values of the bit-exact K1 cases: decode sizes, bucket edges, odd
# counts and the prefill sizes of the serving path.
K1_CASE_MS = (1, 3, 7, 8, 9, 16, 17, 509, 512)


def parent_k1(torch, ops, a, w, a_scale, w_scale, bias, out_scale, *,
              relu=False, requant=False):
    """The byte-masked mma.sync kernel (``cim_matmul_launch``, the masked
    path, K1's previous design, its code unchanged) on the same inputs:
    the parent's K1 timed in this run at shapes that now take the wgmma
    path."""
    from repro_torch.kernels import build
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), device="cuda",
                      dtype=torch.int8 if requant else torch.float32)
    rc = ops._fn()(a.data_ptr(), int(a.dtype == torch.float32),
                   w.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                   bias.data_ptr(), out_scale.data_ptr(), out.data_ptr(), m,
                   n, k, int(relu), int(requant),
                   torch.cuda.current_stream().cuda_stream)
    build.check(rc, "cim_matmul (masked kernel)")
    return out


def parent_k4(torch, ops, a, w, plane):
    """The byte-masked bit-plane kernel (``bitplane_matmul_launch``, K4's
    previous design, unchanged) on the same inputs."""
    from repro_torch.kernels import build
    (m, k), n = a.shape, w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device="cuda")
    rc = ops._fn()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   plane, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "bitplane_matmul (masked kernel)")
    return out


def in_turns(timer, new, parent):
    """new, parent, parent, new: each kernel's mean of its two turns."""
    t = [timer.ms(new), timer.ms(parent), timer.ms(parent), timer.ms(new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def k1_times(torch, timer, ops, args) -> dict:
    """K1's config, plain-version and yardstick times and bound for one
    f32-input call ``args`` (cim_matmul_kernel's).  The yardstick is
    torch._int_mm on the pre-quantized A (it needs M > 16, so decode's A
    is padded to 32 rows) + the epilogue; the bound counts A (f32), W,
    the scale and bias vectors and the f32 output once."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import autotune
    a, w, a_scale, w_scale, bias, _ = args
    (m, k), n = a.shape, w.shape[1]
    a_pad = torch.zeros(max(m, 32), k, dtype=torch.int8, device="cuda")
    a_pad[:m] = torch.clamp(torch.round(a / a_scale), -128, 127).to(
        torch.int8)

    def library():
        acc = torch._int_mm(a_pad, w)
        return acc[:m].to(torch.float32) * (a_scale * w_scale) + bias

    n_bytes = m * k * 4 + k * n + 2 * n * 4 + m * n * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n, hw().PEAK_FLOPS_INT8)
    return {"config": autotune.cim_matmul_config(
                m, n, k, sm_count("cuda"))._asdict(),
            "plain_ms": timer.ms(lambda: ops.cim_matmul_plain(*args),
                                 iters=3),
            "library_ms": timer.ms(library), "bound_ms": b_ms,
            "bound_by": b_by}


def check_k1(torch, timer, ops, gen):
    """cim_matmul against its plain version: bit-exact at every (K, N) of
    the model, every M of K1_CASE_MS, f32 and int8 input, requant on and
    off, and at VGG-8's ragged shapes; then timed at every (K, N) at
    decode M = 8 and prefill M = 512 beside the masked kernel (in turns) and
    the ``torch._int_mm`` + epilogue yardstick."""
    dev = "cuda"
    n_cases = 0
    for k, n in K1_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        a_scale = torch.tensor(0.05, device=dev)
        out_scale = torch.tensor(0.5, device=dev)
        for m in K1_CASE_MS:
            a32 = torch.randn(m, k, generator=gen, device=dev) * 2.0
            a8 = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            for a in (a32, a8):
                for requant in (False, True):
                    args = (a, w, a_scale, w_scale, bias, out_scale)
                    got = ops.cim_matmul_kernel(*args, requant=requant)
                    want = ops.cim_matmul_plain(*args, requant=requant)
                    if not torch.equal(got, want):
                        bad = (got != want).sum().item()
                        raise AssertionError(
                            f"K1 not bit-exact at M={m} K={k} N={n} "
                            f"a={a.dtype} requant={requant}: {bad} of "
                            f"{got.numel()} outputs differ")
                    n_cases += 1
    # VGG-8's ragged shapes (conv1 K = 27, head N = 10), with the VGG
    # epilogue (bias + ReLU).
    for m, k, n in ((32768, 27, 128), (32, 1024, 10)):
        w = rand_i8(torch, (k, n), gen, -127)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-2 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        a_scale = torch.tensor(0.02, device=dev)
        out_scale = torch.tensor(0.05, device=dev)
        a32 = torch.rand(m, k, generator=gen, device=dev) * 2.0 - 0.5
        for a in (a32, rand_i8(torch, (m, k), gen)):
            for relu, requant in ((True, False), (True, True),
                                  (False, False)):
                args = (a, w, a_scale, w_scale, bias, out_scale)
                got = ops.cim_matmul_kernel(*args, relu=relu,
                                            requant=requant)
                want = ops.cim_matmul_plain(*args, relu=relu,
                                            requant=requant)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K1 not bit-exact at ragged M={m} K={k} N={n} "
                        f"a={a.dtype} relu={relu} requant={requant}")
                n_cases += 1
    # Timing at every serving (K, N), decode and prefill, f32 input (what
    # the serving path passes).
    a_scale = torch.tensor(0.05, device=dev)
    one = torch.tensor(1.0, device=dev)
    rows = []
    for k, n in K1_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3
        bias = torch.zeros(n, device=dev)
        for m in (8, 512):
            a = torch.randn(m, k, generator=gen, device=dev)
            args = (a, w, a_scale, w_scale, bias, one)
            ms, parent_ms, turns = in_turns(
                timer, lambda: ops.cim_matmul_kernel(*args),
                lambda: parent_k1(torch, ops, *args))
            rows.append({"M": m, "K": k, "N": n, "ms": ms,
                         "parent_ms": parent_ms, "turns_ms": turns,
                         **k1_times(torch, timer, ops, args)})
    main = next(r for r in rows if (r["M"], r["K"], r["N"]) == (8, 4096,
                                                                 12288))
    return {"name": "cim_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/cim_matmul.cu",
            "replaces": "src/repro/kernels/cim_matmul/kernel.py:121",
            "max_abs_err": 0.0, "cases": n_cases,
            "case_ms": list(K1_CASE_MS),
            "ragged_cases": "M=32768 K=27 N=128, M=32 K=1024 N=10",
            "shape": "M=8 K=4096 N=12288 f32 in",
            "ms": main["ms"], "parent_ms": main["parent_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "torch._int_mm on the pre-quantized A (M padded to "
                       "32 at decode) + epilogue",
            "parent": "the masked kernel (cim_matmul_launch), K1's "
                      "previous design, same inputs, in turns",
            "shapes": rows}


def _pool(torch, gen, nb, bs, kvh, d, int8):
    shape = (nb, bs, kvh, d)
    if int8:
        codes = [torch.randint(-127, 128, shape, generator=gen,
                               device="cuda", dtype=torch.int32).to(
                                   torch.int8) for _ in range(2)]
        scales = [(torch.rand(shape[:3], generator=gen, device="cuda")
                   * 0.02 + 0.005).to(torch.bfloat16) for _ in range(2)]
        return codes, scales
    pages = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2)]
    return pages, [None, None]


def _dense_kv(torch, pages, scale, tables, n_tokens):
    """[B, W*BS, KVH, D] f32 view of each row's pages (for SDPA)."""
    g = pages[tables.long()].to(torch.float32)
    if scale is not None:
        g = g * scale[tables.long()].to(torch.float32)[..., None]
    b, w, bs = g.shape[:3]
    return g.reshape(b, w * bs, *g.shape[3:])[:, :n_tokens]


def k2_times(torch, timer, ops, args, splits) -> dict:
    """Kernel (at ``splits``), plain-version and SDPA-yardstick times of
    one K2 call over an int8 pool and its bound: ``args`` are
    paged_attention_kernel's.  The yardstick is SDPA over the gathered,
    dequantized live pages; the bound counts each live token's codes and
    scales once, q, the partials and the tables, operations 4 D a live
    token and query head (QK and PV)."""
    q, kp, vp, ks, vs, tables, lengths = args
    b, kvh, g, d = q.shape
    s_max = tables.shape[1] * kp.shape[1]
    kd = _dense_kv(torch, kp, ks, tables, s_max)
    vd = _dense_kv(torch, vp, vs, tables, s_max)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(g, 1)
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(g, 1)
    qd = q.reshape(b, kvh * g, 1, d).to(torch.float32)
    mask = (torch.arange(s_max, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tokens = int(lengths.sum())
    n_bytes = (tokens * kvh * (2 * d + 2 * 2) + q.numel() * 2
               + b * kvh * g * (d + 2) * 4 + tables.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4.0 * tokens * kvh * g * d,
                          attention_peak(torch, q.dtype))
    return {"ms": timer.ms(lambda: ops.paged_attention_kernel(
                *args, kv_splits=splits)),
            "plain_ms": timer.ms(lambda: ops.paged_attention_plain(
                *args, kv_splits=splits), iters=5),
            "library_ms": timer.ms(lambda: sdpa(qd, kd, vd,
                                                attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by}


def check_k2(torch, timer, ops, gen):
    """paged_attention against its plain version, bf16 and int8 pools,
    B=8 ragged lengths up to 2048 with one empty row, at kv_splits=1 (the
    count the decode kernel was first timed at), at the card's split
    count (a caller without an engine) and at the pages per split a
    serving engine fixes for a 200-page widest table (the serve loop's
    decode).  Also times kernel + merge over a grid of table widths and
    batches, the per-width split heuristic beside an engine's fixed pages
    per split (:func:`split_sweep`)."""
    from repro_torch.kernels import autotune
    b, kvh, g, d, bs = 8, 8, 4, 128, 16
    lengths = torch.tensor([2048, 1, 777, 0, 1500, 64, 1999, 300],
                           dtype=torch.int32, device="cuda")
    w = 2048 // bs
    card_splits = autotune.heuristic_paged_splits_cuda(
        b, kvh, w, ops.sm_count("cuda"))
    engine_pps = autotune.paged_split_pages(b, kvh, 200,
                                            ops.sm_count("cuda"))
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32).contiguous()
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    entry = None
    err = 0.0
    for int8 in (False, True):
        (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
        args = (q, kp, vp, ks, vs, tables, lengths)
        for split in ({"kv_splits": 1}, {"kv_splits": card_splits},
                      {"split_pages": engine_pps}):
            got = ops.merge_splits(*ops.paged_attention_kernel(
                *args, **split))
            want = ops.merge_splits(*ops.paged_attention_plain(
                *args, **split))
            e = (got - want).abs().max().item()
            # f32 sums in another order than the plain version's einsum.
            if not e <= 1e-3:
                raise AssertionError(f"K2 int8={int8} {split}: max abs err "
                                     f"{e} > 1e-3")
            if got[3].abs().max().item() != 0.0:
                raise AssertionError("K2: the n_valid=0 row is not zeros")
            err = max(err, e)
        if int8:
            entry = {"name": "paged_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/paged_attention.cu",
                     "replaces":
                         "src/repro/kernels/paged_attention/kernel.py:217",
                     "shape": f"B={b} KVH={kvh} G={g} D={d} BS={bs} "
                              f"int8 pool, {int(lengths.sum())} live "
                              "tokens",
                     "kv_splits": card_splits,
                     "ms_splits1": timer.ms(lambda: ops.paged_attention_kernel(
                         *args, kv_splits=1)),
                     **k2_times(torch, timer, ops, args, card_splits),
                     "library": "scaled_dot_product_attention over the "
                                "gathered dequantized pages"}
    entry["max_abs_err"] = err
    entry["split_sweep"] = split_sweep(torch, timer, ops, gen)
    return entry


def split_sweep(torch, timer, ops, gen, max_width: int = 512):
    """K2 + merge (both kernels) on full int8 tables of 4 to 512 pages at
    batch 1 and 8 (KVH=8, G=4, D=128, BS=16): the per-width split
    heuristic beside the pages per split an engine whose widest table is
    ``max_width`` pages fixes, which a row's bits do not depend on."""
    from repro_torch.kernels import autotune
    kvh, g, d, bs = 8, 4, 128, 16
    sms = ops.sm_count("cuda")
    rows = []
    for b in (1, 8):
        pps = autotune.paged_split_pages(b, kvh, max_width, sms)
        for w in (4, 32, 128, 512):
            nb = b * w + 1
            perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
            tables = perm.reshape(b, w).to(torch.int32).contiguous()
            lengths = torch.full((b,), w * bs, dtype=torch.int32,
                                 device="cuda")
            (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, True)
            q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(
                torch.bfloat16)
            args = (q, kp, vp, ks, vs, tables, lengths)
            row = {"batch": b, "width": w}
            for tag, split in (
                    ("heuristic", {"kv_splits": autotune
                                   .heuristic_paged_splits_cuda(
                                       b, kvh, w, sms)}),
                    ("engine", {"split_pages": pps})):
                row[f"{tag}_splits"] = ops.split_geometry(w, **split)[0]
                row[f"{tag}_ms"] = timer.ms(
                    lambda: ops.merge_splits_kernel(
                        *ops.paged_attention_kernel(*args, **split)))
            rows.append(row)
            del kp, vp, ks, vs
    return {"max_width": max_width, "rows": rows}


def check_merge(torch, timer, ops, gen):
    """merge_splits_kernel against merge_splits on the partials of the K2
    timing shape at the card's split count, a dead split and an empty row
    included."""
    from repro_torch.kernels import autotune
    b, kvh, g, d = 8, 8, 4, 128
    ns = autotune.heuristic_paged_splits_cuda(b, kvh, 2048 // 16,
                                              ops.sm_count("cuda"))
    acc = torch.randn(b, kvh, ns, g, d, generator=gen, device="cuda")
    m = torch.randn(b, kvh, ns, g, 1, generator=gen, device="cuda") * 4
    l = torch.rand(b, kvh, ns, g, 1, generator=gen, device="cuda") + 0.5
    for t, v in ((acc, 0.0), (m, ops.NEG_INF), (l, 0.0)):
        t[0, 0, 1] = v          # a dead split
        t[3] = v                # a row with no live position
    got = ops.merge_splits_kernel(acc, m, l)
    want = ops.merge_splits(acc, m, l)
    err = (got - want).abs().max().item()
    # expf against torch.exp and another summation order over the splits.
    if not err <= 1e-5:
        raise AssertionError(f"merge: max abs err {err} > 1e-5")
    if got[3].abs().max().item() != 0.0:
        raise AssertionError("merge: the empty row is not zeros")
    ms = timer.ms(lambda: ops.merge_splits_kernel(acc, m, l))
    plain_ms = timer.ms(lambda: ops.merge_splits(acc, m, l))
    n_bytes = (acc.numel() + m.numel() + l.numel() + b * kvh * g * d) * 4
    b_ms, b_by = bound_ms(n_bytes, 3.0 * acc.numel(), hw().PEAK_FLOPS_F32)
    return {"name": "merge_splits", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/ops.py:44 "
                        "(merge_splits, the jnp combine of the Pallas "
                        "decode kernel's partials)",
            "max_abs_err": err,
            "shape": f"B={b} KVH={kvh} S={ns} G={g} D={d}",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library": "none: no single PyTorch call combines the splits"}


def check_k3(torch, timer, ops, gen):
    """flash_prefill against its plain version at C=64: outputs within
    1e-3, written pages bit-exact, the masked row's pages untouched; then
    at the suffix-prefill shapes (:func:`k3_suffix_cases`)."""
    b, kvh, g, d, bs, c = 4, 8, 4, 128, 16, 64
    pos = torch.tensor([0, 64, 1024, 64], dtype=torch.int32, device="cuda")
    n_tok = torch.tensor([64, 37, 64, 64], dtype=torch.int32, device="cuda")
    wm = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    w = (1024 + c) // bs
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32).contiguous()
    q32 = torch.randn(b, kvh, c * g, d, generator=gen, device="cuda")
    k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    masked_blocks = tables[3, 64 // bs:(64 + c) // bs].long()
    err = err_bf16 = tol_used = 0.0
    entry = None
    for dtype, int8 in ((torch.float32, False), (torch.float32, True),
                        (torch.bfloat16, False), (torch.bfloat16, True)):
        q, k_new, v_new = (t.to(dtype) for t in (q32, k32, v32))
        (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
        pools = []
        for _ in range(2):
            pools.append([t.clone() if t is not None else None
                          for t in (kp, vp, ks, vs)])
        (k1, v1, ks1, vs1), (k2, v2, ks2, vs2) = pools
        got = ops.flash_prefill_kernel(q, k_new, v_new, k1, v1, ks1, vs1,
                                       tables, pos, n_tok, wm).float()
        want = ops.flash_prefill_plain(q, k_new, v_new, k2, v2, ks2, vs2,
                                       tables, pos, n_tok, wm).float()
        # f32 sums in another order than the plain version's einsum: 1e-3;
        # a bf16 output may also round to the neighbouring bf16 value, so
        # there one bf16 ulp (2**-7 relative) is allowed on top.
        tol = 1e-3 + (2.0 ** -7 * want.abs() if dtype == torch.bfloat16
                      else 0.0)
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(
                f"K3 {dtype} int8={int8}: max abs err {diff.max().item()}")
        if dtype == torch.float32:      # the CUDA-core instantiation
            err = max(err, diff.max().item())
        else:                           # the tensor-core instantiation
            err_bf16 = max(err_bf16, diff.max().item())
            tol_used = max(tol_used, (diff / tol).max().item())
        for a_, b_, orig in ((k1, k2, kp), (v1, v2, vp), (ks1, ks2, ks),
                             (vs1, vs2, vs)):
            if a_ is None:
                continue
            if not torch.equal(a_[1:], b_[1:]):
                raise AssertionError(f"K3 int8={int8}: pages differ")
            if not torch.equal(a_[masked_blocks], orig[masked_blocks]):
                raise AssertionError("K3: a masked row's pages changed")
        if int8 and dtype == torch.bfloat16:
            args = (q, k_new, v_new, k1, v1, ks1, vs1, tables, pos, n_tok,
                    wm)
            entry = {"name": "flash_prefill", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_prefill.cu",
                     "replaces":
                         "src/repro/kernels/paged_attention/kernel.py:480",
                     "shape": f"B={b} C={c} KVH={kvh} G={g} D={d} BS={bs} "
                              "pos=[0,64,1024,64] int8 pool",
                     **k3_times(torch, timer, ops, args, g),
                     "library": "scaled_dot_product_attention per row over "
                                "the gathered past pages + chunk"}
    entry["max_abs_err"] = err
    entry["max_abs_err_bf16"] = err_bf16
    entry["bf16_tolerance_used"] = tol_used
    entry["suffix_cases"] = k3_suffix_cases(torch, timer, ops, gen)
    entry["max_abs_err_suffix"] = max(e["max_abs_err"]
                                      for e in entry["suffix_cases"])
    return entry


def k3_times(torch, timer, ops, args, g) -> dict:
    """Kernel, plain-version and SDPA-yardstick times of one K3 call and
    its bound: ``args`` are flash_prefill_kernel's (int8 pool), ``g`` the
    GQA group.  The bound counts this call's data: each row's past pages
    read once, its chunk's queries, keys and values, the output, and the
    pages it writes where its mask is set; operations 4·keys·D per query
    head and position (QK and PV), causal within the chunk."""
    q, k_new, v_new, k1, v1, ks1, vs1, tables, pos, n_tok, wm = args
    b, kvh, cg, d = q.shape
    c = k_new.shape[1]
    bs = k1.shape[1]
    ms = timer.ms(lambda: ops.flash_prefill_kernel(*args))
    plain_ms = timer.ms(lambda: ops.flash_prefill_plain(*args), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = []
    for r in range(b):
        p0 = int(pos[r])
        past_k = _dense_kv(torch, k1, ks1, tables[r:r + 1], p0)
        past_v = _dense_kv(torch, v1, vs1, tables[r:r + 1], p0)
        kk = torch.cat([past_k, k_new[r:r + 1].float()], 1)
        vv = torch.cat([past_v, v_new[r:r + 1].float()], 1)
        kk = kk.permute(0, 2, 1, 3).repeat_interleave(g, 1)
        vv = vv.permute(0, 2, 1, 3).repeat_interleave(g, 1)
        qq = q[r].reshape(kvh, c, g, d).permute(0, 2, 1, 3).reshape(
            1, kvh * g, c, d).float()
        mask = (torch.arange(p0 + c, device="cuda")[None, :]
                <= p0 + torch.arange(c, device="cuda")[:, None])
        calls.append((qq, kk, vv, mask))
    library_ms = timer.ms(
        lambda: [sdpa(qq, kk, vv, attn_mask=mk) for qq, kk, vv, mk in calls])
    n_ops = 0.0
    n_bytes = (q.numel() * 2 * 2 + k_new.numel() * 2 * 2
               + tables.numel() * 4)
    for r in range(b):
        p0, nt = int(pos[r]), int(n_tok[r])
        keys = sum(p0 + min(ci + 1, nt) for ci in range(c))
        n_ops += 4.0 * keys * kvh * g * d
        n_bytes += p0 * kvh * (2 * d + 4)
        if int(wm[r]):
            n_bytes += -(-nt // bs) * bs * kvh * (2 * d + 4)
    b_ms, b_by = bound_ms(n_bytes, n_ops, attention_peak(torch, q.dtype))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def k3_suffix_cases(torch, timer, ops, gen) -> list:
    """K3 at the prefix cache's suffix-prefill shapes (the durable phase's
    requests): one row, a pow2 chunk C of whole blocks starting past the
    system prompt, the table a pow2 cover of the prompt, bf16
    queries over the int8 pool; the exact hit's last block (C = 16 at pos
    = prompt - 16); and C = 512.  Each on both write-mask values: the
    output (the masked row's included, which an exact hit reads) within
    1e-3 plus one bf16 ulp of the plain version, written pages bit-exact,
    and with the mask at 0 no page changed."""
    kvh, g, d, bs = 8, 4, 128, 16
    exact_hits = {(SYS_LEN + SUFFIX_LENS[i] - bs, bs, bs)
                  for i in DUPLICATES}
    shapes = sorted({(SYS_LEN, n, bs * next_pow2(-(-n // bs)))
                     for n in SUFFIX_LENS} | exact_hits
                    | {(SYS_LEN, 500, 512)})
    cases = []
    for pos0, n, c in shapes:
        w = next_pow2(-(-(pos0 + c) // bs))
        nb = w + 1
        tables = (torch.randperm(nb - 1, generator=gen, device="cuda")
                  + 1)[None].to(torch.int32).contiguous()
        q = torch.randn(1, kvh, c * g, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k_new, v_new = (torch.randn(1, c, kvh, d, generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for _ in range(2))
        (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, True)
        pos = torch.tensor([pos0], dtype=torch.int32, device="cuda")
        n_tok = torch.tensor([n], dtype=torch.int32, device="cuda")
        for write in (1, 0):
            wm = torch.tensor([write], dtype=torch.int32, device="cuda")
            p1 = [t.clone() for t in (kp, vp, ks, vs)]
            p2 = [t.clone() for t in (kp, vp, ks, vs)]
            got = ops.flash_prefill_kernel(q, k_new, v_new, *p1, tables,
                                           pos, n_tok, wm).float()
            want = ops.flash_prefill_plain(q, k_new, v_new, *p2, tables,
                                           pos, n_tok, wm).float()
            diff = (got - want).abs()
            tol = 1e-3 + 2.0 ** -7 * want.abs()
            if not bool((diff <= tol).all()):
                raise AssertionError(
                    f"K3 suffix C={c} pos={pos0} wm={write}: max abs err "
                    f"{diff.max().item()}")
            for a_, b_, orig in zip(p1, p2, (kp, vp, ks, vs)):
                if not torch.equal(a_[1:], b_[1:]):
                    raise AssertionError(f"K3 suffix C={c}: pages differ")
                if not write and not torch.equal(a_, orig):
                    raise AssertionError(
                        f"K3 suffix C={c}: a masked row changed a page")
            args = (q, k_new, v_new, *p1, tables, pos, n_tok, wm)
            cases.append({"shape": f"B=1 C={c} pos={pos0} n_tok={n} W={w} "
                                   f"KVH={kvh} G={g} D={d} BS={bs} "
                                   f"write_mask={write} int8 pool",
                          "max_abs_err": diff.max().item(),
                          "bf16_tolerance_used": (diff / tol).max().item(),
                          **k3_times(torch, timer, ops, args, g)})
    return cases


def check_k4(torch, timer, ops, gen):
    """bitplane_matmul against its plain version at all 8 VGG-8 layer
    shapes and every plane, bit-exact; bitserial_matmul through the kernel
    against the same shift-add over the plain planes, bit for bit; then
    one plane timed at every shape beside the masked kernel (in turns) and
    ``torch._int_mm``."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import autotune
    n_cases = 0
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        for plane in range(8):
            got = ops.bitplane_matmul_kernel(a, w, plane)
            want = ops.bitplane_matmul_plain(a, w, plane)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K4 not bit-exact at M={m} K={k} N={n} plane={plane}: "
                    f"{(got != want).sum().item()} outputs differ")
            n_cases += 1
        w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-2
        bias = torch.randn(n, generator=gen, device="cuda")
        a_scale = torch.tensor(0.02, device="cuda")
        got = ops.bitserial_matmul(a, w, a_scale, w_scale, bias, relu=True)
        with swapped(ops, "bitplane_matmul_kernel",
                     ops.bitplane_matmul_plain):
            want = ops.bitserial_matmul(a, w, a_scale, w_scale, bias,
                                        relu=True)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 bitserial_matmul differs from its "
                                 f"plain twin at M={m} K={k} N={n}")
    # Timing at every layer shape, one plane (the sign plane).
    rows = []
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        ms, parent_ms, turns = in_turns(
            timer, lambda: ops.bitplane_matmul_kernel(a, w, 7),
            lambda: parent_k4(torch, ops, a, w, 7))
        plain_ms = timer.ms(lambda: ops.bitplane_matmul_plain(a, w, 7),
                            iters=3)
        # Yardstick: torch._int_mm on the plane, extracted beforehand.  It
        # needs M > 16 and K, N multiples of 8: conv1 (K = 27) and the
        # head (N = 10) have no such call.
        library_ms = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            bits = ((a.view(torch.uint8) >> 7) & 1).view(torch.int8)
            library_ms = timer.ms(lambda: torch._int_mm(bits, w))
        b_ms, b_by = bound_ms(m * k + k * n + m * n * 4, 2.0 * m * k * n,
                              hw().PEAK_FLOPS_INT8)
        rows.append({"M": m, "K": k, "N": n,
                     "config": autotune.cim_matmul_config(
                         m, n, k, sm_count("cuda"))._asdict(),
                     "ms": ms, "parent_ms": parent_ms, "turns_ms": turns,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    main = rows[1]
    return {"name": "bitplane_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/bitplane_matmul.cu",
            "replaces": "src/repro/kernels/bitserial_matmul/kernel.py:62",
            "max_abs_err": 0.0, "cases": n_cases,
            "shape": "M=32768 K=1152 N=128 (conv2), one plane",
            "ms": main["ms"], "parent_ms": main["parent_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "torch._int_mm on the pre-extracted plane",
            "parent": "the masked kernel (bitplane_matmul_launch), K4's "
                      "previous design, same inputs, in turns",
            "shapes": rows}


def code_diff(torch, got, want, what: str) -> dict:
    """The K5 tolerance against the simulation: its float64 tree combine
    runs in another order than the op's W_eff sum and converts in another
    order in f32, so a code may move by one where v * 128 lands within an
    ulp of a .5 boundary -- on at most 1e-3 of the outputs, and never by
    more than one."""
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    worst = int(d.max()) if d.numel() else 0
    n_off = int((d > 0).sum())
    share = n_off / max(d.numel(), 1)
    if worst > 1 or share > 1e-3:
        raise AssertionError(f"{what}: max |code diff| {worst}, "
                             f"{n_off} of {d.numel()} codes differ")
    return {"max_abs": worst, "codes_off_by_one": n_off,
            "codes": d.numel()}


def k5_chip(torch):
    """The K5 checks' macro (1152 rows, nominal mismatch), one chip
    sampled at PRNGKey(1234), and a full scale ~2.7 std of a random tile
    MAC (codes span the range)."""
    from repro_torch import prng
    from repro_torch.core import macro
    cfg = macro.nominal_config(rows=1152)
    chip = macro.sample_chip(prng.PRNGKey(1234, device="cuda"), cfg)
    v_fs = torch.tensor(0.02 * cfg.rows * 127.0 * 127.0, device="cuda")
    return cfg, chip, v_fs


def k5_whole_op_ms(torch, timer, ops, gen) -> list:
    """cim_macro_matmul, wrapper included, at every VGG-8 shape (ReLU on):
    its time, and the device memory one call adds at its peak over what
    was allocated before it.  Uses only the op's public signature, so
    ``--src`` can measure another tree's op (the parent's) with this
    script."""
    cfg, chip, v_fs = k5_chip(torch)
    rows = []
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)

        def op():
            return ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=True)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        op()
        torch.cuda.synchronize()
        rows.append({"M": m, "K": k, "N": n,
                     "whole_op_peak_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9,
                     "whole_op_ms": timer.ms(op, iters=5)})
    return rows


def check_k5(torch, timer, ops, gen):
    """caat_mac against its plain version through cim_macro_matmul at the
    conv2 (1 tile), conv6 (4 tiles) and fc1 (8 tiles) shapes with a
    sampled chip, ReLU on and off: codes equal; and, with an ideal ADC,
    against the behavioural macro simulation (core.macro.cim_matmul_sim)
    within the code tolerance.  Then timed at every VGG-8 shape, one launch
    per row tile on operands made once, beside the plain version, two
    library yardsticks (f32 ``torch.bmm`` over 9 folded planes, and
    ``torch._int_mm`` over the stacked +/-1 planes + the float64 combine,
    both on planes made outside the timing), the bound, and the whole
    cim_macro_matmul call."""
    from repro_torch.core import adc, macro, numerics
    cfg, chip, v_fs = k5_chip(torch)
    sim_chip = {"caat": chip["caat"], "adc": adc.ideal_adc(cfg.adc, "cuda")}
    checks = []
    for m, k, n in (VGG8_SHAPES[1], VGG8_SHAPES[5], VGG8_SHAPES[6]):
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        for relu in (True, False):
            got = ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=relu)
            with swapped(ops, "caat_mac_kernel", ops.caat_mac_plain):
                want = ops.cim_macro_matmul(a, w, chip, v_fs, cfg,
                                            relu=relu)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 not equal to its plain version at M={m} K={k} "
                    f"N={n} relu={relu}: {int((got != want).sum())} of "
                    f"{got.numel()} codes differ")
            sim, _ = macro.cim_matmul_sim(a, w, sim_chip, v_fs, cfg,
                                          relu=relu)
            checks.append({
                "shape": [m, k, n], "relu": relu, "vs_plain": "equal",
                "vs_sim": code_diff(torch, got, sim.to(torch.int32),
                                    f"K5 vs sim M={m} relu={relu}")})
    whole = k5_whole_op_ms(torch, timer, ops, gen)
    f64 = torch.float64
    rows = []
    for (m, k, n), whole_row in zip(VGG8_SHAPES, whole):
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        tiles, w_eff, scalars = ops.tile_operands(a, w, chip, v_fs, cfg,
                                                  relu=True)
        r = cfg.rows
        kp = r * len(tiles)

        def run(fn):
            for tile in tiles:
                fn(*tile, w_eff, scalars)

        ms = timer.ms(lambda: run(ops.caat_mac_kernel))
        plain_ms = timer.ms(lambda: run(ops.caat_mac_plain), iters=3)
        # Library yardsticks on planes made here, outside the timing.
        a_p = torch.nn.functional.pad(a, (0, kp - k))
        w_p = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
        w_pm = numerics.encode_pm1(w_p)                      # [K', N, 9]
        a_pm = numerics.encode_pm1(a_p)                      # [B, K', 9]
        a_fold = torch.einsum("bri,ij->jbr", a_pm.to(f64), w_eff).to(
            torch.float32)
        del a_pm
        w_f32 = w_pm.permute(2, 0, 1).to(torch.float32).contiguous()

        def epilogue(acc):
            v = (acc * scalars[0] + scalars[1]) * scalars[2]
            code = torch.clamp(torch.round(v * 128.0), -128, 127)
            return code.to(torch.int32)

        def bmm_library():
            out = 0
            for t in range(len(tiles)):
                sl = slice(t * r, (t + 1) * r)
                out = out + epilogue(torch.bmm(a_fold[:, :, sl],
                                               w_f32[:, sl]).sum(0))
            return torch.clamp_min(out, 0)

        bmm_ms = timer.ms(bmm_library)
        del a_fold, w_f32
        stacked = [(ops.pm1_planes(a_t).reshape(8 * m, r),
                    w_pm[t * r:(t + 1) * r, :, :8].permute(0, 2, 1)
                    .reshape(r, 8 * n).contiguous())
                   for t, (a_t, _, _) in enumerate(tiles)]
        w_sums = [ws.to(f64) for _, _, ws in tiles]
        we64 = w_eff[:8, :8].reshape(64)

        def int8_library():
            out = 0
            for (a8, w8), ws in zip(stacked, w_sums):
                count = torch._int_mm(a8, w8).view(8, m, 8, n)
                acc = count.permute(1, 3, 0, 2).reshape(m * n, 64).to(
                    f64) @ we64
                row = a8.view(8, m, r).sum(-1, dtype=torch.int32).to(f64)
                acc = (acc.view(m, n) - (w_eff[:8, 8] @ row)[:, None]
                       - (w_eff[8, :8] @ ws)[None, :] + w_eff[8, 8] * r)
                out = out + epilogue(acc.to(torch.float32))
            return torch.clamp_min(out, 0)

        int8_ms = timer.ms(int8_library, iters=5)
        del stacked
        n_bytes = (m * kp + sum(t[1].numel() + t[2].numel() * 4
                                for t in tiles) + 81 * 8 + 16 + m * n * 4)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * 64 * m * kp * n,
                              hw().PEAK_FLOPS_INT8)
        rows.append({"M": m, "K": k, "N": n, "tiles": len(tiles), "ms": ms,
                     "plain_ms": plain_ms, "bmm_library_ms": bmm_ms,
                     "int8_library_ms": int8_ms, "bound_ms": b_ms,
                     "bound_by": b_by, **whole_row})
    main = rows[1]
    return {"name": "caat_mac", "route": "cuda",
            "source": "src/repro_torch/csrc/caat_mac.cu",
            "replaces": "src/repro/kernels/caat_mac/kernel.py:84",
            "max_abs_err": 0.0,
            "error_unit": "ADC codes against the plain version (equal); "
                          "vs_sim: |diff| <= 1 on <= 1e-3 of outputs",
            "checks": checks,
            "shape": "B=32768 R=1152 N=128 (conv2), one tile, 64 int8 "
                     "plane products",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["int8_library_ms"],
            "library": "torch._int_mm over the stacked +/-1 planes "
                       "[8B, R] x [R, 8N] + the float64 combine",
            "bmm_library_ms": main["bmm_library_ms"],
            "bmm_library": "torch.bmm over the 9 W_eff-folded f32 planes "
                           "(TF32 off) + epilogue",
            "whole_op_ms": main["whole_op_ms"],
            "bound_rate": "int8 tensor cores, 1979 TOP/s",
            "shapes": rows}


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions(cim_ops, paged_ops):
    """Route the kernel wrappers to their plain twins (the replay;
    these calls are not counted as launches)."""
    with swapped(cim_ops, "cim_matmul_kernel", cim_ops.cim_matmul_plain), \
            swapped(paged_ops, "paged_attention_kernel",
                    paged_ops.paged_attention_plain), \
            swapped(paged_ops, "merge_splits_kernel",
                    paged_ops.merge_splits), \
            swapped(paged_ops, "flash_prefill_kernel",
                    paged_ops.flash_prefill_plain):
        yield


# The serving phases' model and requests: qwen3-8b frozen under
# w8a8_kernel (a_scale 0.05) from seed 0, 8 prompts of these lengths drawn
# from seed 1, 32 new tokens each.
PROMPT_LENS = (512, 64, 200, 96, 384, 128, 256, 80)
ARRIVALS = (0, 0, 0, 2, 4, 8, 8, 16)
MAX_NEW = 32
SAMPLE_SEED, TEMPERATURE = 7, 0.8
# The serving phases (main, static, blocking, durable) run qwen3-8b at 12
# of its 36 layers: their time is the host's per-layer work, and at all 36
# the script outgrew its time limit.  The distributed and dryrun phases
# keep all 36 (K1 4,048 a mesh serve; 36 x 7 + 1 records a decode step).
SERVE_LAYERS = 12


def frozen_params(torch, cfg, device, cache=None):
    """The serving phases' parameters; returns (params, plan, init_s).
    With a ``cache`` dict they are made once per (cfg, device) and kept
    there for the next serving phase."""
    from repro_torch.core import backend
    from repro_torch.models import model as M
    key = (cfg, str(device))
    if cache is None or key not in cache:
        plan = backend.load_plan("w8a8_kernel")
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.freeze_params(M.init(cfg, gen, device=device),
                                 a_scale=0.05, plan=plan)
        if device == "cuda":
            torch.cuda.synchronize()
        built = (params, plan, time.perf_counter() - t0)
        if cache is None:
            return built
        cache[key] = built
    return cache[key]


def serving_requests(torch, cfg):
    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(1)
    return [Request(rid=i, prompt=torch.randint(
                0, cfg.vocab, (n,), generator=rng).numpy(),
                max_new=MAX_NEW, arrival_step=a)
            for i, (n, a) in enumerate(zip(PROMPT_LENS, ARRIVALS))]


def chunked_prefill_logits(torch, params, cfg, prompt, mode, *, chunk,
                           device, recompute_tail: int = 0):
    """One prompt's last logits through model.prefill_chunk over a fresh
    pool of 16-token blocks (int8 under an int8 ``cfg``).  With
    ``recompute_tail`` also the logits of the prompt's last
    ``recompute_tail`` tokens prefilled once more as one chunk over the
    pages the prompt left, its page writes masked: what an
    exact-full-prompt prefix hit computes.  Returns the logits, or
    (logits, recomputed logits)."""
    from repro_torch.models import model as M
    from repro_torch.serve import kv_pool
    n = len(prompt)
    nblk = -(-n // 16)
    pages = kv_pool.init_pages(cfg, nblk + 1, 16, torch.bfloat16,
                               device=device)
    tables = torch.arange(1, nblk + 1, dtype=torch.int32,
                          device=device)[None]
    prompt = torch.as_tensor(prompt, device=device).long()
    starts = list(range(0, n, chunk))
    if recompute_tail:
        starts.append(n - recompute_tail)
    out = []
    for i, c0 in enumerate(starts):
        end = min(c0 + chunk, n)
        toks = torch.zeros(1, chunk, dtype=torch.long, device=device)
        toks[0, :end - c0] = prompt[c0:end]
        lg, pages = M.prefill_chunk(
            params, toks, cfg, pages=pages, block_tables=tables,
            pos=torch.tensor([c0], device=device),
            n_tok=torch.tensor([end - c0], device=device),
            write_mask=torch.tensor([i < len(starts) - 1 or not
                                     recompute_tail], device=device),
            has_past=c0 > 0, mode=mode)
        if end == n:
            out.append(lg[0, :cfg.vocab].float())
    return tuple(out) if recompute_tail else out[0]


def reset_launches(cim_ops, paged_ops):
    cim_ops.launches = 0
    paged_ops.decode_launches = 0
    paged_ops.prefill_launches = 0
    paged_ops.merge_launches = 0


def read_launches(cim_ops, paged_ops) -> dict:
    return {"cim_matmul": cim_ops.launches,
            "paged_attention": paged_ops.decode_launches,
            "flash_prefill": paged_ops.prefill_launches,
            "merge_splits": paged_ops.merge_launches}


def logit_gate(torch, pf_logits, tokens_kernel, tokens_plain, *,
               run_floor: bool = False) -> dict:
    """Kernel vs plain prefill logits against the plain-vs-plain
    reordering floor (``pf_logits`` holds "kernel", "plain" and "reorder"
    lists), and first tokens that differ beyond that noise: each
    request's own floor, or with ``run_floor`` the largest of the run's
    (the model's reordering noise; at a few layers the two plain orders
    can coincide bit for bit on a prompt, a floor of 0 that measures no
    reordering)."""
    d_kp, d_floor, scale, margins = [], [], [], []
    ties, mismatch, gaps = [], [], {}
    for i, (lk, lp, lr) in enumerate(zip(*pf_logits.values())):
        d_kp.append((lk - lp).abs().max().item())
        d_floor.append((lp - lr).abs().max().item())
        scale.append(lp.abs().max().item())
        top2 = lp.topk(2).values
        margins.append(float(top2[0] - top2[1]))
        tk, tp = int(tokens_kernel[i][0]), int(tokens_plain[i][0])
        if tk != tp:
            gaps[i] = float(lp[tp] - lp[tk])
    for i, gap in gaps.items():
        # A different first token is a tie at this precision only when the
        # kernel's pick is within the reordering noise (plain vs plain) of
        # the plain maximum.
        floor = max(d_floor) if run_floor else d_floor[i]
        (ties if gap <= floor else mismatch).append(i)
    failures = []
    # Tolerance: reordering the attention sums alone moves these logits by
    # several percent of their range (the plain-vs-plain noise floor), so
    # kernel vs plain agreement is held to 1.5x that measured floor.
    if not max(d_kp) <= 1.5 * max(d_floor):
        failures.append(f"prefill logits differ by {max(d_kp)}, beyond 1.5x "
                        f"the noise floor {max(d_floor)}")
    if mismatch:
        failures.append(f"first tokens of {mismatch} differ beyond the "
                        "logit noise")
    return {"first_tokens_identical": sum(
                int(int(a[0]) == int(b[0]))
                for a, b in zip(tokens_kernel, tokens_plain)),
            "first_token_ties": ties, "first_token_mismatches": mismatch,
            "first_token_plain_logit_gaps": gaps,
            "prefill_logit_max_abs_diff": d_kp,
            "prefill_logit_noise_floor": d_floor,
            "prefill_logit_range": scale,
            "prefill_top2_margin_plain": margins}, failures


def main_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
              chunk: int = 64, cache=None):
    """Serve 8 requests through the port's ContinuousEngine at ``cfg``'s
    widths, then replay them through the plain versions.  (``device`` and
    ``chunk`` let the same code be rehearsed at a reduced size on CPU.)"""
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, RequestStatus

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, init_s = frozen_params(torch, cfg, device, cache)
    reqs = serving_requests(torch, cfg)
    kw = dict(plan=plan, max_batch=8, kv_blocks=512, block_size=16,
              segment_len=8, paged_attn=True, chunked_prefill=True,
              prefill_chunk=chunk, device=device)

    ce = ContinuousEngine(params, cfg, **kw)
    reset_launches(cim_ops, paged_ops)
    sync()
    t0 = time.perf_counter()
    res = ce.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(cim_ops, paged_ops)
    n_tok = sum(len(r.tokens) for r in res.values())
    bad = [rid for rid, r in res.items() if r.status is not RequestStatus.OK]
    if len(res) != len(reqs) or bad:
        raise AssertionError(f"requests not OK: {bad}")
    for name, n in launches.items():
        if n <= 0 and device == "cuda":
            raise AssertionError(f"{name} never launched on the main path")
    ce.allocator.check_invariants()

    # Device time by kernel: the same requests once more, each kernel
    # wrapper (and the partials' merge) bracketed by CUDA events.  Not the
    # timed run: the events add host work.
    kernel_time = None
    if device == "cuda":
        # An event pair spans the wrapper's host work too when the card
        # waits for the host, so the same run is also traced with
        # torch.profiler for the kernels' own device time.
        from torch.profiler import ProfilerActivity, profile
        ce_ev = ContinuousEngine(params, cfg, **kw)
        wrappers = ((cim_ops, "cim_matmul_kernel"),
                    (paged_ops, "paged_attention_kernel"),
                    (paged_ops, "flash_prefill_kernel"),
                    (paged_ops, "merge_splits_kernel"))
        # Calls made inside model.prefill_chunk are tagged "prefill", the
        # rest "decode", so K1's time splits by phase.
        phase = ["decode"]

        def prefill_tagged(*a, _fn=M.prefill_chunk, **k):
            phase[0] = "prefill"
            try:
                return _fn(*a, **k)
            finally:
                phase[0] = "decode"

        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                swapped(M, "prefill_chunk", prefill_tagged), \
                event_timed(torch, wrappers, lambda: phase[0]) as events:
            sync()
            t0 = time.perf_counter()
            ce_ev.run(reqs)
            sync()
            ev_wall = time.perf_counter() - t0
        kernel_time = {"phase": "main_kernel_time", "wall_s": ev_wall,
                       "timed_run_wall_s": wall, "events": {},
                       "profiler": device_time_by_kernel(prof, ev_wall)}
        for name, triples in events.items():
            entry = {}
            for tag in (None, "decode", "prefill"):
                sel = [(a, b) for a, b, t in triples
                       if tag is None or t == tag]
                ms = sum(a.elapsed_time(b) for a, b in sel)
                entry[tag or "all"] = {"calls": len(sel), "ms": ms,
                                       "share_of_wall": ms / (ev_wall * 1e3)}
            kernel_time["events"][name] = entry
        emit(kernel_time)

    # Replay through the plain versions on the card.
    ce_plain = ContinuousEngine(params, cfg, **kw)
    with plain_versions(cim_ops, paged_ops):
        res_plain = ce_plain.run(reqs)
    agree = [float((res[i].tokens == res_plain[i].tokens).mean())
             for i in sorted(res)]

    # Each request's prefill logits (its first-token decision), straight
    # through the model three ways: with the kernels, with their plain
    # twins, and with the plain gather-then-attend reference, whose
    # attention sums the same values in yet another order.  The last pair
    # measures how far reordering alone moves the logits (the noise floor
    # of a random-weight bf16 W8A8 model SERVE_LAYERS deep).
    runs = {"kernel": (False, ce.plan), "plain": (True, ce.plan),
            "reorder": (True, dataclasses.replace(ce.plan,
                                                  paged_attn=False))}
    pf_logits = {name: [] for name in runs}
    for name, (plain, mode) in runs.items():
        ctx = (plain_versions(cim_ops, paged_ops) if plain
               else contextlib.nullcontext())
        with ctx:
            for r in reqs:
                pf_logits[name].append(chunked_prefill_logits(
                    torch, params, cfg, r.prompt, mode, chunk=chunk,
                    device=device))
    gate, failures = logit_gate(
        torch, pf_logits, [res[r.rid].tokens for r in reqs],
        [res_plain[r.rid].tokens for r in reqs])
    result = {"phase": "main",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "layers": cfg.n_layers,
              "requests": len(res), "tokens": n_tok, "wall_s": wall,
              # One cold run: the wall time holds prefill, decode and the
              # process's first-call CUDA start-up.
              "tokens_per_wall_s": n_tok / wall, "init_s": init_s,
              "segments": ce.last_run_segments,
              "prefill_chunks": ce.last_run_prefill_chunks,
              "launches": launches,
              "kernel_device_time": kernel_time,
              **gate,
              "first_tokens": [int(res[i].tokens[0]) for i in sorted(res)],
              "first_tokens_plain": [int(res_plain[i].tokens[0])
                                     for i in sorted(res)],
              "stream_agreement": agree,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if device == "cuda" else None)}
    result["ok"] = not failures
    return result, launches, failures


# ---------------------------------------------------------------------------
# The autotuner's measured table
# ---------------------------------------------------------------------------

# K1's qwen3-8b shapes the phase tunes: (K, N) of q/o, k/v, gate/up and
# down, at a decode batch and a prefill chunk, int8 and f32 inputs.
AUTOTUNE_KN = K1_SHAPES[:4]
AUTOTUNE_M = (8, 512)
# The serving runs: qwen3-8b at full width and a cut depth, the first
# AUTOTUNE_REQUESTS of the serving phases' prompts, AUTOTUNE_NEW tokens,
# on the main phase's pool geometry (whose engine key the phase tunes).
AUTOTUNE_LAYERS, AUTOTUNE_REQUESTS, AUTOTUNE_NEW = 4, 4, 16
AUTOTUNE_BATCH, AUTOTUNE_BLOCKS, AUTOTUNE_BS = 8, 512, 16


def autotune_k1(torch, autotune, cim_ops, gen, sms, device) -> list:
    """(a): every candidate config of each K1 shape gives the heuristic
    config's bytes (f32 out, with a bias), then ``autotune.measure``
    times them all (host wall clock, the JAX package's method) and
    records the fastest.  On the card the heuristic's and the chosen
    config's device times (``Timer``: L2 flushed, the host's enqueue
    hidden) are printed beside them."""
    timer = Timer(torch) if device == "cuda" else None
    # Scales already on the device: the wrapper copies nothing from the
    # host (a copy would stall it behind the Timer's device sleep), so
    # the device times are the kernels'.
    a_s, one = (torch.tensor(v, device=device) for v in (0.05, 1.0))
    rows = []
    for k, n in AUTOTUNE_KN:
        w = rand_i8(torch, (k, n), gen)
        ws = torch.rand(n, generator=gen, device="cuda") * 1e-3
        bias = torch.randn(n, generator=gen, device="cuda")
        for m in AUTOTUNE_M:
            for dtype in (torch.int8, torch.float32):
                a = (rand_i8(torch, (m, k), gen) if dtype == torch.int8
                     else torch.randn(m, k, generator=gen, device="cuda"))
                cands = autotune.candidate_configs(m, k, n, sms)
                outs = [cim_ops.cim_matmul(a, w, a_s, ws, bias, one,
                                           requant=False, config=c)
                        for c in cands]
                differ = [tuple(c) for c, o in zip(cands, outs)
                          if not torch.equal(o, outs[0])]
                best, us = autotune.measure(m, k, n, dtype,
                                            candidates=cands, device=device)
                row = {"phase": "autotune_k1", "m": m, "k": k, "n": n,
                       "dtype": autotune.dtype_name(dtype),
                       "candidates": len(cands),
                       "heuristic": tuple(cands[0]),
                       "heuristic_us": us[cands[0]], "best": tuple(best),
                       "best_us": us[best], "configs_differing": differ}
                if timer is not None:
                    for name, c in (("heuristic", cands[0]), ("best", best)):
                        row[f"{name}_device_ms"] = timer.ms(
                            lambda c=c: cim_ops.cim_matmul(
                                a, w, a_s, ws, bias, one, requant=False,
                                config=c))
                emit(row)
                rows.append(row)
    return rows


def autotune_k2(torch, autotune, paged_ops, gen, key, device) -> dict:
    """(b): ``measure_paged`` at the engine's key, and the best split's K2
    output held against its plain version (1e-3, as check_k2)."""
    b, kvh, width, bs, d, g = key
    best, us = autotune.measure_paged(b, kvh, width, bs, torch.int8,
                                      head_dim=d, groups=g, device=device)
    (kp, vp), (ks, vs) = _pool(torch, gen, width * b + 1, bs, kvh, d, True)
    perm = torch.randperm(width * b, generator=gen, device="cuda") + 1
    tables = perm.reshape(b, width).to(torch.int32).contiguous()
    lengths = torch.randint(1, width * bs + 1, (b,), generator=gen,
                            device="cuda", dtype=torch.int32)
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (q, kp, vp, ks, vs, tables, lengths)
    got = paged_ops.merge_splits_kernel(*paged_ops.paged_attention_kernel(
        *args, kv_splits=best))
    want = paged_ops.merge_splits(*paged_ops.paged_attention_plain(
        *args, kv_splits=best))
    return {"best": best, "us": us, "heuristic_cuda":
            autotune.heuristic_paged_splits_cuda(b, kvh, width,
                                                 paged_ops.sm_count("cuda")),
            "max_abs_err": (got - want).abs().max().item()}


def autotune_path(torch, cfg, cim_ops, paged_ops, *, device="cuda"):
    """The autotuner's measured table on the card: (a) K1's candidate
    configs byte-identical and timed at qwen3-8b's shapes, (b) K2's
    split and K3's chunk measured at the main phase's engine key, (c)
    the table dumped, cleared and loaded back, (d) a ContinuousEngine
    (``cfg`` cut to AUTOTUNE_LAYERS) served with no table, with the K1
    entries only (streams identical) and with the whole table (the
    engine takes the loaded chunk and split; streams identical where
    both equal the heuristic's, else the main phase's logit gate).  The
    tables are cleared at the end, so the phases after run as before."""
    import numpy as np

    from repro_torch.kernels import autotune, build
    from repro_torch.serve import ContinuousEngine, RequestStatus
    sms = paged_ops.sm_count(device)
    gen = torch.Generator(device=device).manual_seed(4321)
    kvh, d = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kvh
    width = AUTOTUNE_BLOCKS - 1
    failures = []
    try:
        autotune.clear()
        k1 = autotune_k1(torch, autotune, cim_ops, gen, sms, device)
        bad = [(r["m"], r["k"], r["n"], r["dtype"]) for r in k1
               if r["configs_differing"]]
        if bad:
            failures.append(f"K1 configs differ from the heuristic's bytes "
                            f"at {bad}")
        k2 = autotune_k2(torch, autotune, paged_ops, gen,
                         (AUTOTUNE_BATCH, kvh, width, AUTOTUNE_BS, d, g),
                         device)
        if not k2["max_abs_err"] <= 1e-3:
            failures.append(f"K2 at the measured split {k2['best']}: max "
                            f"abs err {k2['max_abs_err']} > 1e-3")
        chunk, chunk_us = autotune.measure_prefill(
            AUTOTUNE_BATCH, kvh, AUTOTUNE_BS, torch.int8, head_dim=d,
            groups=g, device=device)

        # (c) dump, clear, load: every choice as measured.
        path = build.build_dir() / "autotune_table.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        table = json.loads(autotune.dump(str(path)))
        dumped = sum(len(table[f]) for f in ("gemm_entries",
                                             "paged_entries",
                                             "prefill_entries"))
        autotune.clear()
        loaded = autotune.load(str(path))
        lost = [r for r in k1 if autotune.choose_config(
            r["m"], r["k"], r["n"], r["dtype"], sms) != tuple(r["best"])]
        engine_key = dict(head_dim=d, groups=g)
        if (loaded != dumped or lost
                or autotune.measured_paged_splits(
                    AUTOTUNE_BATCH, kvh, width, AUTOTUNE_BS, torch.int8,
                    **engine_key) != k2["best"]
                or autotune.choose_prefill_chunk(
                    AUTOTUNE_BATCH, kvh, AUTOTUNE_BS, torch.int8,
                    **engine_key) != chunk):
            failures.append(f"the loaded table differs from the measured "
                            f"one (dumped {dumped}, loaded {loaded}, K1 "
                            f"lost {len(lost)})")

        # (d) three serving runs.
        small = dataclasses.replace(cfg, n_layers=AUTOTUNE_LAYERS)
        params, plan, _ = frozen_params(torch, small, device)
        reqs = [dataclasses.replace(r, max_new=AUTOTUNE_NEW) for r in
                serving_requests(torch, small)[:AUTOTUNE_REQUESTS]]
        k1_only = json.dumps({"gemm_entries": table["gemm_entries"]})
        runs, launches = {}, {}
        for name, text in (("no_table", None), ("k1_table", k1_only),
                           ("whole_table", str(path))):
            autotune.clear()
            if text is not None:
                autotune.load(text)
            ce = ContinuousEngine(
                params, small, plan=plan, max_batch=AUTOTUNE_BATCH,
                kv_blocks=AUTOTUNE_BLOCKS, block_size=AUTOTUNE_BS,
                segment_len=8, paged_attn=True, chunked_prefill=True,
                device=device)
            reset_launches(cim_ops, paged_ops)
            t0 = time.perf_counter()
            res = ce.run(reqs)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = read_launches(cim_ops, paged_ops)
            if any(r.status is not RequestStatus.OK for r in res.values()):
                failures.append(f"{name}: a request is not OK")
            if device == "cuda" and min(launches[name].values()) <= 0:
                failures.append(f"{name}: a kernel never launched "
                                f"({launches[name]})")
            runs[name] = {"prefill_chunk": ce.prefill_chunk,
                          "split_pages": ce.split_pages, "wall_s": wall,
                          "streams": [res[r.rid].tokens for r in reqs]}

        def same(a, b):
            return [bool(np.array_equal(x, y)) for x, y in
                    zip(runs[a]["streams"], runs[b]["streams"])]

        k1_same = same("no_table", "k1_table")
        if not all(k1_same):
            failures.append(f"K1-only table: streams differ {k1_same}")
        whole, base = runs["whole_table"], runs["no_table"]
        want_pps = -(-width // k2["best"]) if device == "cuda" else None
        if (whole["prefill_chunk"], whole["split_pages"]) != (chunk,
                                                              want_pps):
            failures.append(f"the engine took chunk {whole['prefill_chunk']}"
                            f" and {whole['split_pages']} pages per split, "
                            f"not the loaded {chunk} and {want_pps}")
        whole_same = same("no_table", "whole_table")
        gate = None
        if (whole["prefill_chunk"], whole["split_pages"]) == (
                base["prefill_chunk"], base["split_pages"]):
            if not all(whole_same):
                failures.append(f"whole table at the heuristic's choices: "
                                f"streams differ {whole_same}")
        else:
            # The main phase's rule at the loaded chunk: kernel vs plain
            # prefill logits within 1.5x the reordering floor; the plain
            # first token is the plain prefill's argmax.
            modes = {"kernel": (False, ce.plan), "plain": (True, ce.plan),
                     "reorder": (True, dataclasses.replace(
                         ce.plan, paged_attn=False))}
            pf = {name: [] for name in modes}
            for name, (plain, mode) in modes.items():
                ctx = (plain_versions(cim_ops, paged_ops) if plain
                       else contextlib.nullcontext())
                with ctx:
                    for r in reqs:
                        pf[name].append(chunked_prefill_logits(
                            torch, params, small, r.prompt, mode,
                            chunk=whole["prefill_chunk"], device=device))
            gate, gate_failures = logit_gate(
                torch, pf, whole["streams"],
                [[int(lp.argmax())] for lp in pf["plain"]], run_floor=True)
            failures += [f"whole table: {f}" for f in gate_failures]
    finally:
        autotune.clear()
    total = {k: sum(c[k] for c in launches.values())
             for k in launches["no_table"]}
    result = {"phase": "autotune",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "layers": AUTOTUNE_LAYERS, "requests": len(reqs),
              "k1_shapes": len(k1),
              "k1_best_differs_from_heuristic": sum(
                  r["best"] != r["heuristic"] for r in k1),
              "k2": {**k2, "key": [AUTOTUNE_BATCH, kvh, width, AUTOTUNE_BS,
                                   d, g, "int8"]},
              "k3": {"best": chunk, "us_per_token": chunk_us,
                     "heuristic": autotune.heuristic_prefill_chunk(
                         AUTOTUNE_BS)},
              "table": {"path": str(path), "dumped": dumped,
                        "loaded": loaded},
              "runs": {name: {k: v for k, v in r.items() if k != "streams"}
                       for name, r in runs.items()},
              "k1_table_streams_identical": k1_same,
              "whole_table_streams_identical": whole_same,
              "logit_gate": gate, "launches_by_run": launches}
    result["ok"] = not failures
    return result, total, failures


# ---------------------------------------------------------------------------
# The static engine, blocking prefill and the sampler
# ---------------------------------------------------------------------------

def sampler_check(torch, engine, vocab: int, device="cuda"):
    """The seeded sampler on the card against the CPU: a [8, vocab] draw's
    random bits equal bit for bit, its gumbel within 2 ulp; then the
    engine's sampler's time per call at batch 1 and 8 (CUDA events, mean
    of 20)."""
    from repro_torch import prng
    failures = []
    rids = torch.arange(8, dtype=torch.int32)
    keys = prng.fold_in(prng.fold_in(
        prng.PRNGKey(SAMPLE_SEED).expand(8, 2), rids), 3)
    bits_cpu = prng.random_bits(keys, (vocab,))
    bits_dev = prng.random_bits(keys.to(device), (vocab,))
    g_cpu = prng.gumbel(keys, (vocab,))
    g_dev = prng.gumbel(keys.to(device), (vocab,))
    bits_equal = torch.equal(bits_dev.cpu(), bits_cpu)
    # Within 2 f32 ulp of max(|g|, 1): near g = 0 the outer log passes its
    # input's rounding through as an absolute error.
    gumbel_ok = bool(((g_dev.cpu() - g_cpu).abs() <= 2 * torch.finfo(
        torch.float32).eps * g_cpu.abs().clamp_min(1.0)).all())
    logits = torch.randn(8, vocab, generator=torch.Generator().manual_seed(2))
    temp = torch.tensor(TEMPERATURE)
    draw_cpu = prng.categorical(keys, logits / temp)
    draw_dev = prng.categorical(keys.to(device), logits.to(device)
                                / temp.to(device)).cpu()
    if not bits_equal:
        failures.append("the card's random bits differ from the CPU's")
    if not gumbel_ok:
        failures.append("the card's gumbel is not within 2 ulp of the CPU's")
    result = {"random_bits_equal": bits_equal, "gumbel_within_2ulp": gumbel_ok,
              "gumbel_max_abs_diff": float((g_dev.cpu() - g_cpu).abs().max()),
              "categorical_equal": int((draw_dev == draw_cpu).sum()),
              "shape": [8, vocab]}
    if device == "cuda":
        sample = engine.make_sample(engine.plan, greedy=False)
        key = prng.PRNGKey(SAMPLE_SEED, device=device)
        for b in (1, 8):
            lg = logits[:b].to(device)
            r = torch.arange(b, dtype=torch.int32, device=device)
            t_dev = temp.to(device)
            for _ in range(3):
                sample(lg, key, r, 5, t_dev)
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(20):
                sample(lg, key, r, 5, t_dev)
            e.record()
            e.synchronize()
            result[f"sample_ms_b{b}"] = a.elapsed_time(e) / 20
    return result, failures


def static_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                chunk: int = 64, cache=None):
    """The static engine (``Engine.generate`` over dense KV caches) at
    ``cfg``'s widths under w8a8_kernel: the 8 serving prompts, one call
    each (bucketed to 32), 32 new tokens, greedy with the kernels (K1 must
    launch on every linear of every prefill and decode step) and twice
    sampled with one key (identical streams).  Prefill logits are gated
    as the main path's, against the plain versions' prefill (whose
    argmax is the plain greedy run's first token); the decode step is
    timed greedy and sampled, and the sampler alone."""
    from repro_torch import prng
    from repro_torch.serve import Engine

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, init_s = frozen_params(torch, cfg, device, cache)
    prompts = [torch.as_tensor(r.prompt) for r in serving_requests(torch,
                                                                   cfg)]
    max_len = max(PROMPT_LENS) + MAX_NEW + 32
    eng = Engine(params, cfg, max_len=max_len, plan=plan, device=device)
    key = prng.PRNGKey(SAMPLE_SEED, device=device)

    def serve(sampled: bool):
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = [eng.generate({"tokens": p[None]}, max_new_tokens=MAX_NEW,
                            temperature=TEMPERATURE if sampled else 0.0,
                            key=key if sampled else None, request_ids=[i])
               for i, p in enumerate(prompts)]
        sync()
        wall = time.perf_counter() - t0
        toks = [r.tokens[0].cpu() for r in out]
        n = sum(len(t) for t in toks)
        return toks, {"wall_s": wall, "tokens": n,
                      "tokens_per_wall_s": n / wall,
                      "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                      if device == "cuda" else None)}

    reset_launches(cim_ops, paged_ops)
    greedy, run_greedy = serve(False)
    launches = read_launches(cim_ops, paged_ops)
    sampled_a, run_sampled_a = serve(True)
    sampled_b, run_sampled_b = serve(True)

    failures = []
    # K1 on every linear: 7 per layer and the head, in the prefill and in
    # each of the MAX_NEW decode steps of every call.
    want_k1 = len(prompts) * (MAX_NEW + 1) * (7 * cfg.n_layers + 1)
    if device == "cuda" and launches["cim_matmul"] != want_k1:
        failures.append(f"K1 launched {launches['cim_matmul']} times on the "
                        f"static path, not once per linear ({want_k1})")
    if not all(torch.equal(a, b) for a, b in zip(sampled_a, sampled_b)):
        failures.append("two sampled runs with one key differ")

    pf_logits = {"kernel": [], "plain": [], "reorder": []}
    prefill = eng.prefill_fn(plan)
    for p in prompts:
        batch = eng.bucket({"tokens": p[None].to(device)})
        pf_logits["kernel"].append(
            prefill(params, batch)[0][0, -1, :cfg.vocab].float())
        with plain_versions(cim_ops, paged_ops):
            pf_logits["plain"].append(
                prefill(params, batch)[0][0, -1, :cfg.vocab].float())
            # The same logits through the chunked paged prefill's gather
            # reference: another summation order of the same attention.
            pf_logits["reorder"].append(chunked_prefill_logits(
                torch, params, cfg, p.numpy(),
                dataclasses.replace(plan, paged_attn=False), chunk=chunk,
                device=device))
    # The plain greedy run's first tokens: its prefill's argmax (a whole
    # plain run of the 8 prompts cost ~15-80 s of the script's limit).
    first_plain = [lp.argmax().reshape(1) for lp in pf_logits["plain"]]
    gate, gate_failures = logit_gate(torch, pf_logits, greedy, first_plain)
    failures += gate_failures

    # Time of one decode step at batch 1 after the longest prompt, greedy
    # and sampled (host clock around 16 steps, synchronized), beside the
    # sampler alone.
    step_ms = {}
    batch = eng.bucket({"tokens": prompts[0][None].to(device)})
    rids = torch.zeros(1, dtype=torch.int32, device=device)
    temp = torch.tensor(TEMPERATURE, device=device)
    for greedy_step in (True, False):
        step = eng.make_step(plan, greedy_step)
        logits, caches = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        tok, _, _, caches = step(params, tok, caches, key, rids, 1, temp)
        sync()
        t0 = time.perf_counter()
        for t in range(16):
            tok, _, _, caches = step(params, tok, caches, key, rids, t + 2,
                                     temp)
        sync()
        step_ms["greedy" if greedy_step else "sampled"] = \
            (time.perf_counter() - t0) / 16 * 1e3
    sampler, sampler_failures = sampler_check(torch, eng, cfg.padded_vocab,
                                              device)
    failures += sampler_failures
    if "sample_ms_b1" in sampler:
        sampler["share_of_sampled_step"] = (sampler["sample_ms_b1"]
                                            / step_ms["sampled"])

    result = {"phase": "static",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "layers": cfg.n_layers, "calls": len(prompts),
              "prompt_lens": list(PROMPT_LENS), "max_new": MAX_NEW,
              "buckets": [int(eng.bucket({"tokens": p[None]})["tokens"]
                              .shape[1]) for p in prompts],
              "init_s": init_s, "launches": launches,
              "k1_launches_expected": want_k1,
              "runs": {"greedy": run_greedy, "sampled": run_sampled_a,
                       "sampled_again": run_sampled_b},
              "sampled_equal_greedy": [
                  float((a == b).float().mean()) for a, b in
                  zip(sampled_a, greedy)],
              **gate,
              "decode_step_ms_b1": step_ms, "sampler": sampler}
    result["ok"] = not failures
    return result, launches, failures


def blocking_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                  cache=None):
    """The serving path with blocking prefill (the ContinuousEngine
    default): the main path's requests and pool, paged attention,
    sampled at temperature 0.8 with one key; every request must be OK and
    K1 and K2 must launch."""
    from repro_torch import prng
    from repro_torch.serve import ContinuousEngine, RequestStatus

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, _ = frozen_params(torch, cfg, device, cache)
    reqs = serving_requests(torch, cfg)
    ce = ContinuousEngine(params, cfg, plan=plan, max_batch=8,
                          kv_blocks=512, block_size=16, segment_len=8,
                          paged_attn=True, chunked_prefill=False,
                          device=device)
    reset_launches(cim_ops, paged_ops)
    sync()
    t0 = time.perf_counter()
    res = ce.run(reqs, key=prng.PRNGKey(SAMPLE_SEED, device=device),
                 temperature=TEMPERATURE)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(cim_ops, paged_ops)
    ce.allocator.check_invariants()
    failures = []
    bad = [rid for rid, r in res.items() if r.status is not RequestStatus.OK]
    if len(res) != len(reqs) or bad:
        failures.append(f"blocking-prefill requests not OK: {bad}")
    for name in ("cim_matmul", "paged_attention"):
        if device == "cuda" and launches[name] <= 0:
            failures.append(f"{name} never launched on the blocking path")
    n_tok = sum(len(r.tokens) for r in res.values())
    result = {"phase": "blocking", "layers": cfg.n_layers,
              "requests": len(res), "ok_requests": len(res) - len(bad),
              "tokens": n_tok, "wall_s": wall,
              "tokens_per_wall_s": n_tok / wall,
              "prefills": ce.last_run_prefills,
              "prefill_s": ce.last_run_prefill_seconds,
              "segments": ce.last_run_segments, "launches": launches,
              "temperature": TEMPERATURE,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if device == "cuda" else None)}
    result["ok"] = not failures
    return result, launches, failures


# ---------------------------------------------------------------------------
# The durable phase: prefix cache, page-out, drain and restore
# ---------------------------------------------------------------------------

# Eight requests share a 256-token system prompt (16 blocks) and carry
# unique suffixes of 32-224 tokens; requests 6 and 7 repeat requests 0 and
# 5 whole (block-aligned, so they are exact prefix hits).  Prompts from
# seed 2, MAX_NEW new tokens each, greedy.
SYS_LEN = 256
SUFFIX_LENS = (32, 224, 96, 160, 48, 128)
DUPLICATES = (0, 5)
DURABLE_ARRIVALS = (0, 1, 1, 2, 3, 3, 6, 40)
STORM_SHORT = 8          # page-out pool: blocks short of the worst case
DRAIN_AT_STEP = 16        # drain at the first event of this sim step
DRAIN_DEADLINE = 2        # ... giving the running requests 2 more steps
MAX_BLOCKS_PER_REQ = 32   # the longest request, 256 + 224 + MAX_NEW tokens


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def durable_requests(torch, cfg):
    import numpy as np

    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(2)
    system = torch.randint(0, cfg.vocab, (SYS_LEN,), generator=rng).numpy()
    prompts = [np.concatenate([system, torch.randint(
                   0, cfg.vocab, (n,), generator=rng).numpy()])
               for n in SUFFIX_LENS]
    prompts += [prompts[i].copy() for i in DUPLICATES]
    return [Request(rid=100 + i, prompt=p, max_new=MAX_NEW, arrival_step=a)
            for i, (p, a) in enumerate(zip(prompts, DURABLE_ARRIVALS))]


def exact_gate(ref: dict, got: dict, what: str):
    """Streams of ``got`` against ``ref`` ({rid: RequestResult}): the
    same tokens and the same logprobs, bit for bit."""
    import numpy as np
    diff = [rid for rid, r in ref.items()
            if rid not in got or not np.array_equal(r.tokens, got[rid].tokens)
            or not np.array_equal(r.logprobs, got[rid].logprobs)]
    lp = max((float(abs(r.logprobs - got[rid].logprobs).max())
              for rid, r in ref.items() if rid in got
              and len(r.logprobs) == len(got[rid].logprobs)
              and len(r.logprobs)), default=0.0)
    failures = [f"{what}: streams of {diff} differ from the reference "
                f"(tokens or logprobs; max logprob diff {lp})"] if diff \
        else []
    return {"identical": len(ref) - len(diff), "differ": diff,
            "max_logprob_diff": lp}, failures


def stream_gate(ref: dict, got: dict, what: str):
    """Greedy streams of ``got`` against ``ref`` ({rid: RequestResult}):
    identical, or first diverging at a tie inside the measured noise.

    The noise is the largest logprob difference of the same token over
    every position before any divergence (all requests).  If the two
    runs' logits differ by at most d, that difference reaches 2d, and at
    a first divergence the gap between the two runs' picked logprobs is
    at most 4d: so a divergence whose gap is within twice the measured
    noise is a tie at this precision, anything else a mismatch."""
    firsts, floor = {}, 0.0
    for rid, r in ref.items():
        a, b = r.tokens, got[rid].tokens
        n = min(len(a), len(b))
        p = next((i for i in range(n) if a[i] != b[i]), n)
        if p:
            floor = max(floor, float(abs(r.logprobs[:p]
                                         - got[rid].logprobs[:p]).max()))
        if p < max(len(a), len(b)):
            firsts[rid] = p
    ties, mismatches, gaps = [], [], {}
    for rid, p in firsts.items():
        a, b = ref[rid], got[rid]
        if p >= min(len(a.tokens), len(b.tokens)):
            mismatches.append(rid)          # lengths differ, no stop tokens
            continue
        gaps[rid] = float(abs(a.logprobs[p] - b.logprobs[p]))
        (ties if gaps[rid] <= 2 * floor else mismatches).append(rid)
    failures = [f"{what}: streams of {mismatches} differ beyond the "
                f"logprob noise {floor}"] if mismatches else []
    return {"identical": len(ref) - len(firsts), "ties": ties,
            "mismatches": mismatches, "first_divergence": firsts,
            "divergence_logprob_gaps": gaps,
            "max_logprob_diff_before_divergence": floor}, failures


def exact_hits(ce, reqs, block_size: int) -> dict:
    """{rid: suffix start} of the requests of ``ce``'s last run that were
    exact-full-prompt prefix hits (only their last block recomputed),
    from the engine's trace."""
    lens = {r.rid: r.prompt_len for r in reqs}
    return {ev["tid"] - ce.tracer.req_tid(0): ev["args"]["suffix_start"]
            for ev in ce.tracer.to_chrome()["traceEvents"]
            if ev["name"] == "prefix_hit"
            and lens.get(ev["tid"] - ce.tracer.req_tid(0), 0)
            - ev["args"]["suffix_start"] <= block_size}


def durable_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                 chunk: int = 64, cache=None):
    """The durable serving modes at ``cfg``'s widths (the main path's
    model, w8a8_kernel, int8 pool, paged attention, greedy):

    * prefix: the durable requests uncached and with ``prefix_cache``,
      blocking and chunked; every request OK, >= 6 hits, >= 2 CoW copies,
      suffix prefills through K3 on the blocking run; blocking first
      tokens held against the uncached run's by :func:`logit_gate`,
      chunked streams against the uncached chunked run's by
      :func:`stream_gate`, except the first token of an exact-full-prompt
      hit, held by :func:`logit_gate` against the floor measured between
      the uncached run's chunks and a recompute of the prompt's last
      block (:func:`chunked_prefill_logits`);
    * page-out: the same requests on a pool STORM_SHORT blocks short of
      their worst case, ``preemption="page_out"``: spills, every request
      OK, tokens and logprobs equal to the unpressured blocking run's
      (:func:`exact_gate`);
    * drain: the cached blocking run drained mid-run into a snapshot in a
      temporary directory, restored into a fresh engine and resumed: the
      union's tokens and logprobs equal the uninterrupted run's
      (:func:`exact_gate`).  Snapshot bytes and the seconds to save and
      restore are reported.

    Every engine has the same geometry (max_batch, max_blocks_per_req),
    which fixes the decode kernel's pages per split: a request then
    decodes to the same bits at every live table width."""
    import os
    import shutil
    import tempfile

    from repro_torch.serve import ContinuousEngine, RequestStatus, kv_pool

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, _ = frozen_params(torch, cfg, device, cache)
    reqs = durable_requests(torch, cfg)
    base = dict(plan=plan, max_batch=8, block_size=16, segment_len=8,
                max_blocks_per_req=MAX_BLOCKS_PER_REQ, paged_attn=True,
                prefill_chunk=chunk, device=device)
    total = {}
    runs, failures = {}, []

    def serve(tag, **kw):
        ce = ContinuousEngine(params, cfg, **dict(base, **kw))
        reset_launches(cim_ops, paged_ops)
        sync()
        t0 = time.perf_counter()
        res = ce.run(reqs)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches(cim_ops, paged_ops)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        ce.allocator.check_invariants()
        bad = [rid for rid, r in res.items()
               if r.status is not RequestStatus.OK]
        if len(res) != len(reqs) or bad:
            failures.append(f"{tag}: requests not OK: {bad}")
        n_tok = sum(len(r.tokens) for r in res.values())
        runs[tag] = {"wall_s": wall, "tokens": n_tok,
                     "tokens_per_wall_s": n_tok / wall,
                     "launches": launches,
                     **{k: getattr(ce, f"last_run_{k}") for k in (
                         "segments", "prefills", "suffix_prefills",
                         "prefix_hits", "prefix_hit_tokens",
                         "prefix_misses", "cow_copies", "preemptions",
                         "spills", "spill_bytes", "restores",
                         "recomputes")}}
        return ce, res

    roomy = dict(kv_blocks=512)
    cached = dict(roomy, prefix_cache=True, preemption="page_out")
    ce_ub, u_b = serve("uncached_blocking", keep_first_logits=True,
                       **roomy)
    ce_cb, c_b = serve("cached_blocking", keep_first_logits=True, **cached)
    full_lg, cached_lg = ce_ub.first_logits, ce_cb.first_logits
    ce_uc, u_c = serve("uncached_chunked", chunked_prefill=True,
                       keep_first_logits=True, **roomy)
    ce_cc, c_c = serve("cached_chunked", chunked_prefill=True,
                       keep_first_logits=True, **cached)
    # Blocking: a prefix hit reads the shared prefix back from the int8
    # pool where a full prefill attends it before quantization, so the
    # first tokens are held by the main phase's logit gate: cached vs full
    # prefill logits within 1.5x the floor measured between the full
    # prefill and chunked prefill (64-token chunks, which read their
    # earlier chunks back from the int8 pool the same way), first tokens
    # identical except ties inside that floor.  Chunked: a hit starts on
    # the same chunk boundary as the uncached run, and the streams must
    # match (stream_gate).
    pf_logits = {
        "kernel": [cached_lg[r.rid][:cfg.vocab] for r in reqs],
        "plain": [full_lg[r.rid][:cfg.vocab] for r in reqs],
        "reorder": [chunked_prefill_logits(torch, params, cfg, r.prompt,
                                           ce_ub.plan, chunk=chunk,
                                           device=device) for r in reqs]}
    gates = {}
    gates["cached_blocking"], fails = logit_gate(
        torch, pf_logits, [c_b[r.rid].tokens for r in reqs],
        [u_b[r.rid].tokens for r in reqs])
    failures += [f"cached_blocking: {f}" for f in fails]
    gates["cached_blocking"]["stream_agreement"] = [
        float((c_b[r.rid].tokens == u_b[r.rid].tokens).mean()) for r in reqs]
    # Chunked: a hit starts on the same chunk boundary as the uncached
    # run, except an exact-full-prompt hit, which recomputes its last
    # 16-token block over the int8 pages.  Its first token is held as
    # the blocking ones are: its logits against the uncached run's within
    # 1.5x the floor measured between the uncached run's 64-token chunks
    # and that recompute of the last block (chunked_prefill_logits), first
    # tokens equal but for ties inside the floor.  A request whose first
    # token tied leaves the stream comparison; every other position and
    # request is held by stream_gate.
    exact = exact_hits(ce_cc, reqs, 16)
    tied = set()
    if not exact:
        failures.append("cached_chunked: no exact-full-prompt prefix hit")
    else:
        recomputed = [chunked_prefill_logits(
            torch, params, cfg, r.prompt, ce_uc.plan, chunk=chunk,
            device=device, recompute_tail=r.prompt_len - exact[r.rid])
            for r in reqs if r.rid in exact]
        hit_reqs = [r for r in reqs if r.rid in exact]
        gate, fails = logit_gate(
            torch, {"kernel": [ce_cc.first_logits[r.rid][:cfg.vocab]
                               for r in hit_reqs],
                    "plain": [ce_uc.first_logits[r.rid][:cfg.vocab]
                              for r in hit_reqs],
                    "reorder": [lr for _, lr in recomputed]},
            [c_c[r.rid].tokens for r in hit_reqs],
            [u_c[r.rid].tokens for r in hit_reqs])
        failures += [f"cached_chunked exact hits: {f}" for f in fails]
        gate["rids"] = [r.rid for r in hit_reqs]
        gate["recomputed_tokens"] = [r.prompt_len - exact[r.rid]
                                     for r in hit_reqs]
        gate["exact_hit_first_token_floor"] = max(
            gate["prefill_logit_noise_floor"])
        gates["cached_chunked_exact_hits"] = gate
        tied = {hit_reqs[i].rid for i in gate["first_token_ties"]}
    gates["cached_chunked"], fails = stream_gate(
        {rid: r for rid, r in u_c.items() if rid not in tied}, c_c,
        "cached_chunked")
    failures += fails
    for tag in ("cached_blocking", "cached_chunked"):
        r = runs[tag]
        if r["prefix_hits"] < 6 or r["cow_copies"] < 2:
            failures.append(f"{tag}: {r['prefix_hits']} prefix hits, "
                            f"{r['cow_copies']} CoW copies (want >= 6, 2)")
    if runs["cached_blocking"]["suffix_prefills"] <= 0:
        failures.append("no suffix prefill on the cached blocking run")
    if device == "cuda" and runs["cached_blocking"]["launches"][
            "flash_prefill"] <= 0:
        failures.append("K3 never launched on the cached blocking run")

    # The requests that run together (all but the late duplicate) at
    # their full length, less STORM_SHORT blocks.
    worst = sum(kv_pool.blocks_for(r.prompt_len + r.max_new, 16)
                for r in reqs if r.arrival_step < MAX_NEW)
    storm_blocks = worst - STORM_SHORT + 1
    _, s = serve("page_out_storm", kv_blocks=storm_blocks,
                 preemption="page_out")
    gates["page_out_storm"], fails = exact_gate(u_b, s, "page_out_storm")
    failures += fails
    if runs["page_out_storm"]["spills"] <= 0:
        failures.append("the page-out storm spilled nothing")

    # Drain mid-run into a snapshot outside the repository, then restore
    # into a fresh engine and resume.
    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        ce = ContinuousEngine(params, cfg, snapshot_dir=snap_dir,
                              **dict(base, **cached))
        reset_launches(cim_ops, paged_ops)
        early, drain_ev, latched = {}, None, False
        for ev in ce.run_stream(reqs):
            if ev["event"] == "finish":
                early[ev["rid"]] = ev["result"]
            elif ev["event"] == "drain":
                drain_ev = ev
            if not latched and ev.get("step", 0) >= DRAIN_AT_STEP:
                ce.drain(deadline_steps=DRAIN_DEADLINE)
                latched = True
        save_s = sum(e["dur"] for e in ce.tracer.to_chrome()["traceEvents"]
                     if e["name"] == "snapshot") / 1e6
        if drain_ev is None or len(early) >= len(reqs):
            failures.append("the drain never cut the run short")
            snap = {}
        else:
            ce2 = ContinuousEngine(params, cfg, snapshot_dir=snap_dir,
                                   **dict(base, **cached))
            sync()
            t0 = time.perf_counter()
            ce2.restore(drain_ev["path"])
            sync()
            restore_s = time.perf_counter() - t0
            resumed = ce2.resume()
            sync()
            ce2.allocator.check_invariants()
            for name, n in read_launches(cim_ops, paged_ops).items():
                total[name] = total.get(name, 0) + n
            union = {**early, **resumed}
            bad = [rid for rid, r in union.items()
                   if r.status is not RequestStatus.OK]
            if len(union) != len(reqs) or bad:
                failures.append(f"drain/restore: requests not OK: {bad}")
            gates["drain_restore"], fails = exact_gate(
                c_b, union, "drain_restore")
            failures += fails
            snap = {"snapshot_bytes": os.path.getsize(drain_ev["path"]),
                    "save_s": save_s, "restore_s": restore_s,
                    "finished_before_drain": len(early),
                    "running_at_drain": drain_ev["running"],
                    "spilled_at_drain": drain_ev["spilled"],
                    "queued_at_drain": drain_ev["queued"],
                    "recoveries": ce2.last_run_recoveries,
                    "restores_after": ce2.last_run_restores}
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    result = {"phase": "durable", "layers": cfg.n_layers,
              "requests": len(reqs),
              "prompt_lens": [r.prompt_len for r in reqs],
              "storm_kv_blocks": storm_blocks, "worst_case_blocks": worst,
              "runs": runs, "gates": gates, "drain": snap,
              "launches": total,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if device == "cuda" else None)}
    result["ok"] = not failures
    return result, total, failures


# ---------------------------------------------------------------------------
# The families phase: the rest of the decoder-only family
# ---------------------------------------------------------------------------

# Each run: (name, arch, layers kept (None: all), path).  Widths are the
# published ones; only depth is cut (the host's per-layer work sets the
# phase's time), and the phase line states each cut.  zamba2 keeps two of
# its shared block's groups of 6, whisper all 32 encoder layers.
FAMILY_RUNS = (
    ("moe-a", "moonshot-v1-16b-a3b", 4, "generate"),
    ("moe-b", "granite-moe-1b-a400m", 8, "generate"),
    ("swa", "h2o-danube-3-4b", 8, "generate"),
    ("dense-g1", "deepseek-7b", 4, "continuous"),
    ("dense-d160", "stablelm-12b", 4, "continuous"),
    ("ssm", "mamba2-1.3b", 12, "generate"),
    ("hybrid", "zamba2-2.7b", 12, "generate"),
    ("encdec", "whisper-large-v3", 8, "generate"),
    ("mrope", "qwen2-vl-72b", 8, "generate"),
)
FAMILY_MOE_PROMPTS = (64, 192, 320, 512)   # whole 64-token chunks
FAMILY_SWA_PROMPT = 4608                   # past the 4096 window, 9 x 512
FAMILY_LONG_PROMPT = 2560                  # past chunked_threshold 2048
# The state-space runs: one call per prompt (each a multiple of min(256,
# S), the SSD chunk; 320 is not), one call of a batch of four 512-token
# prompts, and one 4096-token prompt (16 chunks).
FAMILY_SSM_PROMPTS = (64, 192, 512, 1024)
FAMILY_SSM_BATCH = (4, 512)
FAMILY_SSM_LONG = 4096
# The encoder-decoder run: 30 s of audio (the encoder's 50 frames/s, the
# model's only input length) under decoder prompts of 4 tokens (the
# start-of-transcript sequence) and 64, at batch 1 and 4.
FAMILY_ENCDEC_FRAMES = 1500
FAMILY_ENCDEC_PROMPTS = (4, 64)
FAMILY_ENCDEC_BATCHES = (1, 4)
# The M-RoPE run's prompts, embeddings in place of the vision tower's
# merged output: (text tokens, image grid rows, columns, text after).  64
# text tokens (positions left to their default); 16 + a 16 x 16 grid + 16
# (288); 64 + a 48 x 48 grid + 192 (2560: past chunked_threshold, a 512
# multiple, so attend_chunked).
FAMILY_MROPE_PROMPTS = ((64, 0, 0, 0), (16, 16, 16, 16), (64, 48, 48, 192))
FAMILY_NEW = {"generate": 16, "swa": 32, "continuous": 16, "ssm": 32,
              "encdec": 32, "mrope": 16}
RECURRENT = ("ssm", "hybrid")
# Runs whose kernel and plain prefill logits must be bit-identical (K1 is
# exact and the rest is shared code; the other runs' K2/K3 or reordered
# attention are held to the reordering floor).
BIT_IDENTICAL = ("ssm", "hybrid", "encdec", "mrope")
# Runs that make their embedding and head before the stack: after
# qwen2-vl-72b's 70 GB of int8 blocks there is no room for the f32 draws
# of its 152064 x 8192 embedding (two of 5 GB alive at once).
HEAD_FIRST = ("mrope",)
# Room kept free beside the weights when a run checks that its depth fits
# (a block's masters and freeze temporaries, the prefill's activations,
# the caches, the plain versions' float64 weight blocks).
FIT_HEADROOM_BYTES = 5e9


def family_plan():
    """w8a8_kernel everywhere but the MoE routers (the default deploy
    plan's ``*router*`` rule keeps them float)."""
    from repro_torch.core import backend
    return backend.DeploymentPlan(
        rules=(("*router*", backend.LayerRule("exact")),),
        default="w8a8_kernel")


def family_config(arch: str, layers):
    """The arch at its published widths with ``layers`` blocks (None: all)
    and an int8 KV cache (a sliding window keeps its ring in bf16)."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                               kv_cache_dtype="int8")


def family_params(torch, cfg, plan, device, *, head_first=False):
    """Random weights from seed 0, frozen under ``plan`` one block at a
    time, so no more than one block's bf16 masters is ever held beside
    the int8 model (moonshot-v1-16b-a3b is ~28 B parameters at 48
    layers); a hybrid's shared attention block is made after its SSM
    blocks, an encoder-decoder's encoder before its decoder.  The
    embedding and head come after the stack, or with ``head_first``
    before it.  Returns (params, init seconds)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    dt = torch.bfloat16

    def frozen(tree):
        return M.freeze_params(tree, a_scale=0.05, plan=plan)

    def outer():
        p = {"embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, device=device),
             "final_norm": L.init_rmsnorm(cfg.d_model, device=device),
             "lm_head": frozen({"lm_head": L.init_lm_head(
                 gen, cfg.d_model, cfg.padded_vocab, dt,
                 device=device)})["lm_head"]}
        if cfg.arch_type == "encdec":
            p["enc_final_norm"] = L.init_rmsnorm(cfg.d_model, device=device)
        return p

    params = outer() if head_first else {}
    init = {"moe": T.init_moe_block, "ssm": T.init_ssm_block,
            "hybrid": T.init_ssm_block}.get(cfg.arch_type,
                                            T.init_dense_block)
    lists = (("encoder", T.init_dense_block, cfg.n_enc_layers),
             ("decoder", T.init_decoder_block, cfg.n_layers)) \
        if cfg.arch_type == "encdec" else (("blocks", init, cfg.n_layers),)
    stack = {}
    for name, make, n in lists:
        for _ in range(n):
            blk = {"stack": {name: [make(gen, cfg, dt, device=device)]}}
            stack.setdefault(name, []).extend(frozen(blk)["stack"][name])
            del blk
    if cfg.arch_type == "hybrid":
        stack["shared_attn"] = frozen(
            {"stack": {"shared_attn": T.init_dense_block(
                gen, cfg, dt, device=device)}})["stack"]["shared_attn"]
    if not head_first:
        params = outer()
    params["stack"] = stack
    if device == "cuda":
        torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def block_bytes(cfg) -> int:
    """Bytes of one frozen dense or decoder block's int8 weights (q, k, v,
    o, the MLP; a decoder block adds its cross-attention)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    mlp = (3 if cfg.act == "silu" else 2) * d * cfg.d_ff
    return attn * (2 if cfg.arch_type == "encdec" else 1) + mlp


def fit_depth(torch, cfg, device) -> tuple:
    """The largest depth of a dense or encoder-decoder ``cfg`` whose int8
    blocks, bf16 embedding, int8 head and FIT_HEADROOM_BYTES fit in the
    card's free memory, read now.  Returns (cfg, the memory reading:
    free bytes and what all of ``cfg.n_layers`` would need)."""
    if device != "cuda" or cfg.arch_type not in ("dense", "encdec"):
        return cfg, None
    free, _ = torch.cuda.mem_get_info()
    outer = cfg.padded_vocab * cfg.d_model * 3
    enc = cfg.n_enc_layers * block_bytes(dataclasses.replace(
        cfg, arch_type="dense"))
    need = cfg.n_layers * block_bytes(cfg) + enc + outer + FIT_HEADROOM_BYTES
    reading = {"free_gb": free / 1e9, "need_gb": need / 1e9}
    if need <= free:
        return cfg, reading
    layers = int((free - outer - enc - FIT_HEADROOM_BYTES) // block_bytes(cfg))
    if layers < 1:
        raise MemoryError(f"{cfg.name}: not one block fits ({reading})")
    return dataclasses.replace(cfg, n_layers=layers), reading


def k1_per_layer(cfg) -> int:
    """K1 launches of one block's pass: q, k, v, o, then the MLP's three,
    or three per expert (one per bank) and the shared experts' three; an
    SSM block's in_proj and out_proj; a decoder block's q, k, v, o, its
    cross-attention's q and o (the cross K/V are projected once a
    prefill) and the gelu MLP's in and out."""
    if cfg.arch_type in RECURRENT:
        return 2
    if cfg.arch_type == "encdec":
        return 8
    if cfg.arch_type != "moe":
        return 7
    return 4 + 3 * cfg.moe.n_experts + 3 * bool(cfg.moe.n_shared_experts)


def k1_encoder(cfg) -> tuple:
    """K1 launches of an encoder pass (q, k, v, o, in, out a layer) and of
    one ``precompute_cross_kv`` (k and v a decoder layer); (0, 0) without
    an encoder."""
    if cfg.arch_type != "encdec":
        return 0, 0
    return 6 * cfg.n_enc_layers, 2 * cfg.n_layers


def k1_per_pass(cfg) -> int:
    """K1 launches of one stack pass (a prefill or a decode step): every
    block's, a hybrid's shared attention block once a group (a dense
    block's 7), and the head."""
    shared = (7 * (cfg.n_layers // cfg.hybrid_attn_interval)
              if cfg.arch_type == "hybrid" else 0)
    return cfg.n_layers * k1_per_layer(cfg) + shared + 1


def linear_shapes(cfg) -> list:
    """(K, N) of every deployed linear of ``cfg``: q, k/v, o, the MLP or
    the expert banks, the shared experts and the head; an SSM block's
    in_proj (d -> z, x, B, C, dt) and out_proj."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kn = {(d, cfg.padded_vocab)}
    if cfg.ssm is not None:
        di, n = cfg.ssm.d_inner(d), cfg.ssm.d_state
        kn |= {(d, 2 * di + 2 * n + cfg.ssm.n_heads(d)), (di, d)}
        if cfg.arch_type == "ssm":
            return sorted(kn)
    kn |= {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d)}
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    kn |= {(d, ff), (ff, d)}
    if cfg.moe and cfg.moe.n_shared_experts:
        s = ff * cfg.moe.n_shared_experts
        kn |= {(d, s), (s, d)}
    return sorted(kn)


@contextlib.contextmanager
def counted_passes(T, M):
    """Count the stack passes (``transformer.decode_stack``: a prefill, a
    prefill chunk or a decode step; ``model._prefill_stack``: an ssm or
    hybrid prefill; each ends in one head call) and an encoder-decoder
    prefill's encoder passes (``transformer.apply_encoder``) and cross K/V
    projections (``transformer.precompute_cross_kv``).  Yields ``{"stack":
    n, "encoder": n, "cross_kv": n}``."""
    n = dict.fromkeys(("stack", "encoder", "cross_kv"), 0)

    def counting(fn, what):
        def wrapped(*a, **k):
            n[what] += 1
            return fn(*a, **k)
        return wrapped

    with swapped(T, "decode_stack", counting(T.decode_stack, "stack")), \
            swapped(M, "_prefill_stack", counting(M._prefill_stack,
                                                  "stack")), \
            swapped(T, "apply_encoder", counting(T.apply_encoder,
                                                 "encoder")), \
            swapped(T, "precompute_cross_kv", counting(
                T.precompute_cross_kv, "cross_kv")):
        yield n


@contextlib.contextmanager
def reordered_attention(attn_lib):
    """The same attention in another summation order: whole-prompt
    attention through attend_chunked's online softmax in 64-token chunks,
    and long prompts' attend_chunked in half-size chunks (the reordering
    floor of the Engine.generate runs)."""
    full, chunked = attn_lib.attend_full, attn_lib.attend_chunked

    def full_r(q, k, v, *, causal, window=None, q_offset=0):
        if q.shape[1] % 64 or q_offset or k.shape[1] != q.shape[1]:
            return full(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
        return chunked(q, k, v, causal=causal, window=window, q_chunk=64,
                       kv_chunk=64)

    def chunked_r(q, k, v, *, causal, window=None, q_chunk=512,
                  kv_chunk=1024):
        return chunked(q, k, v, causal=causal, window=window,
                       q_chunk=q_chunk // 2, kv_chunk=kv_chunk // 2)

    with swapped(attn_lib, "attend_full", full_r), \
            swapped(attn_lib, "attend_chunked", chunked_r):
        yield


# (KVH, G, D) of the family's paged attention: deepseek-7b's MHA and
# stablelm-12b's 160-wide heads.
FAMILY_ATTENTION = (("deepseek-7b", 32, 1, 128), ("stablelm-12b", 8, 4, 160))
# (K, N) that K1 also meets at whisper's encoder M: 1500 frames (and 6000
# at batch 4), not a multiple of any row tile.
FAMILY_K1_EXTRA_M = {(1280, 1280): (1500,), (1280, 5120): (1500,)}


def family_k1(torch, timer, ops, gen) -> list:
    """K1 at every deployed (K, N) of the family models (FAMILY_RUNS,
    published widths): bit-exact to its plain version at decode M = 8 and
    prefill M = 512 (and whisper's encoder M, FAMILY_K1_EXTRA_M), f32 and
    int8 input, then timed (f32 input) beside its plain version, the
    ``torch._int_mm`` yardstick and its bound."""
    dev = "cuda"
    shapes = {}
    for _, arch, _, _ in FAMILY_RUNS:
        for kn in linear_shapes(family_config(arch, None)):
            shapes.setdefault(kn, []).append(arch)
    a_scale = torch.tensor(0.05, device=dev)
    one = torch.tensor(1.0, device=dev)
    rows = []
    for (k, n), archs in sorted(shapes.items()):
        w = rand_i8(torch, (k, n), gen, -127)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.zeros(n, device=dev)
        for m in (8, 512, *FAMILY_K1_EXTRA_M.get((k, n), ())):
            a32 = torch.randn(m, k, generator=gen, device=dev) * 2.0
            for a in (a32, rand_i8(torch, (m, k), gen)):
                args = (a, w, a_scale, w_scale, bias, one)
                got = ops.cim_matmul_kernel(*args)
                want = ops.cim_matmul_plain(*args)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K1 not bit-exact at family M={m} K={k} N={n} "
                        f"a={a.dtype}: {(got != want).sum().item()} differ")
            args = (a32, w, a_scale, w_scale, bias, one)
            rows.append({"M": m, "K": k, "N": n, "archs": archs,
                         "ms": timer.ms(lambda: ops.cim_matmul_kernel(*args)),
                         **k1_times(torch, timer, ops, args)})
        del w
    return rows


def family_attention(torch, timer, ops, gen) -> tuple:
    """K2 and K3 at the family's attention shapes (FAMILY_ATTENTION): K2
    over B = 8 ragged rows up to 2048 tokens (one empty), bf16 and int8
    pools, at the card's split count, within 1e-3 of its plain version;
    K3 at C = 64 with past pages, a ragged row and a masked one, bf16
    queries over bf16 and int8 pools, within 1e-3 plus one bf16 ulp with
    pages bit-exact.  Each timed on the int8 pool beside its plain
    version, SDPA and its bound.  Returns (K2 rows, K3 rows)."""
    from repro_torch.kernels import autotune
    k2_rows, k3_rows = [], []
    for arch, kvh, g, d in FAMILY_ATTENTION:
        b, bs = 8, 16
        lengths = torch.tensor([2048, 1, 777, 0, 1500, 64, 1999, 300],
                               dtype=torch.int32, device="cuda")
        w = 2048 // bs
        splits = autotune.heuristic_paged_splits_cuda(
            b, kvh, w, ops.sm_count("cuda"))
        nb = b * w + 1
        tables = ((torch.randperm(nb - 1, generator=gen, device="cuda") + 1)
                  [:b * w].reshape(b, w).to(torch.int32).contiguous())
        q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        err = 0.0
        for int8 in (False, True):
            (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
            args = (q, kp, vp, ks, vs, tables, lengths)
            got = ops.merge_splits_kernel(*ops.paged_attention_kernel(
                *args, kv_splits=splits))
            want = ops.merge_splits(*ops.paged_attention_plain(
                *args, kv_splits=splits))
            err = max(err, (got - want).abs().max().item())
            if not err <= 1e-3 or got[3].abs().max().item() != 0.0:
                raise AssertionError(f"K2 at {arch} (G={g}, D={d}) "
                                     f"int8={int8}: max abs err {err}")
        k2_rows.append({
            "arch": arch, "shape": f"B={b} KVH={kvh} G={g} D={d} BS={bs} "
                                   f"int8 pool, {int(lengths.sum())} live "
                                   "tokens",
            "kv_splits": splits, "max_abs_err": err,
            **k2_times(torch, timer, ops, args, splits)})
        del kp, vp, ks, vs, args

        b, c = 4, 64
        pos = torch.tensor([0, 64, 1024, 64], dtype=torch.int32,
                           device="cuda")
        n_tok = torch.tensor([64, 37, 64, 64], dtype=torch.int32,
                             device="cuda")
        wm = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
        w = (1024 + c) // bs
        nb = b * w + 1
        tables = ((torch.randperm(nb - 1, generator=gen, device="cuda") + 1)
                  [:b * w].reshape(b, w).to(torch.int32).contiguous())
        qp, k_new, v_new = (torch.randn(shape, generator=gen,
                                        device="cuda").to(torch.bfloat16)
                            for shape in ((b, kvh, c * g, d), (b, c, kvh, d),
                                          (b, c, kvh, d)))
        err = 0.0
        for int8 in (False, True):
            (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
            p1 = [t.clone() if t is not None else None
                  for t in (kp, vp, ks, vs)]
            p2 = [t.clone() if t is not None else None
                  for t in (kp, vp, ks, vs)]
            got = ops.flash_prefill_kernel(qp, k_new, v_new, *p1, tables,
                                           pos, n_tok, wm).float()
            want = ops.flash_prefill_plain(qp, k_new, v_new, *p2, tables,
                                           pos, n_tok, wm).float()
            diff = (got - want).abs()
            if not bool((diff <= 1e-3 + 2.0 ** -7 * want.abs()).all()):
                raise AssertionError(f"K3 at {arch} (G={g}, D={d}) "
                                     f"int8={int8}: max abs err "
                                     f"{diff.max().item()}")
            for a_, b_ in zip(p1, p2):
                if a_ is not None and not torch.equal(a_[1:], b_[1:]):
                    raise AssertionError(f"K3 at {arch}: pages differ")
            err = max(err, diff.max().item())
        k3_rows.append({
            "arch": arch, "shape": f"B={b} C={c} KVH={kvh} G={g} D={d} "
                                   f"BS={bs} pos=[0,64,1024,64] int8 pool",
            "max_abs_err": err,
            **k3_times(torch, timer, ops, (qp, k_new, v_new, *p1, tables,
                                           pos, n_tok, wm), g)})
        del kp, vp, ks, vs, p1, p2
    return k2_rows, k3_rows


def family_prompts(torch, cfg, lens, seed=3):
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (n,), generator=rng) for n in lens]


def mrope_positions(torch, n_text, rows, cols, n_after):
    """Qwen2-VL's [3, 1, S] t/h/w positions of ``n_text`` text tokens, a
    ``rows`` x ``cols`` merged image grid and ``n_after`` text tokens:
    text runs t = h = w = i; the grid takes t = offset, h = offset + row,
    w = offset + col; the text after it resumes at offset + max(rows,
    cols)."""
    text = torch.arange(n_text).expand(3, n_text)
    grid = torch.stack([torch.full((rows * cols,), n_text),
                        n_text + torch.arange(rows).repeat_interleave(cols),
                        n_text + torch.arange(cols).repeat(rows)])
    after = (n_text + max(rows, cols)
             + torch.arange(n_after)).expand(3, n_after)
    return torch.cat([text, grid, after], dim=1)[:, None]


def family_inputs(torch, cfg, shape, seed):
    """Seeded bf16 inputs of width d_model at the embedding's scale: the
    encoder's frames or the vision tower's merged embeddings."""
    rng = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, cfg.d_model, generator=rng)
            * cfg.d_model ** -0.5).to(torch.bfloat16)


def family_batches(torch, cfg, prompt_lens=FAMILY_MOE_PROMPTS):
    """The Engine.generate runs' batches (one call each: ``{"tokens": [B,
    S]}``, plus ``frames`` for an encoder-decoder, or ``embeds`` with
    optional ``positions`` in their place for M-RoPE) and new tokens per
    call: the state-space runs' prompts, batch and long prompt; one
    4608-token prompt for a sliding window; whisper's 4 and 64 decoder
    tokens over 1500 frames at batch 1 and 4; qwen2-vl's
    FAMILY_MROPE_PROMPTS; otherwise one prompt of each of
    ``prompt_lens`` (four of 64-512)."""
    if cfg.arch_type == "encdec":
        b = max(FAMILY_ENCDEC_BATCHES)
        frames = family_inputs(torch, cfg, (b, FAMILY_ENCDEC_FRAMES), 6)
        toks = torch.stack(family_prompts(
            torch, cfg, (max(FAMILY_ENCDEC_PROMPTS),) * b))
        return ([{"frames": frames[:n], "tokens": toks[:n, :s]}
                 for n in FAMILY_ENCDEC_BATCHES
                 for s in FAMILY_ENCDEC_PROMPTS], FAMILY_NEW["encdec"])
    if cfg.mrope_sections is not None:
        batches = []
        for i, (n_text, rows, cols, n_after) in enumerate(
                FAMILY_MROPE_PROMPTS):
            s = n_text + rows * cols + n_after
            batch = {"embeds": family_inputs(torch, cfg, (1, s), 7 + i)}
            if rows:
                batch["positions"] = mrope_positions(torch, n_text, rows,
                                                     cols, n_after)
            batches.append(batch)
        return batches, FAMILY_NEW["mrope"]
    if cfg.arch_type in RECURRENT:
        n, s = FAMILY_SSM_BATCH
        prompts = ([p[None] for p in family_prompts(torch, cfg,
                                                    FAMILY_SSM_PROMPTS)]
                   + [torch.stack(family_prompts(torch, cfg, (s,) * n,
                                                 seed=4))]
                   + [family_prompts(torch, cfg, (FAMILY_SSM_LONG,),
                                     seed=5)[0][None]])
        new = FAMILY_NEW["ssm"]
    elif cfg.sliding_window:
        prompts = [p[None] for p in family_prompts(
            torch, cfg, (FAMILY_SWA_PROMPT,))]
        new = FAMILY_NEW["swa"]
    else:
        prompts = [p[None] for p in family_prompts(torch, cfg,
                                                   prompt_lens)]
        new = FAMILY_NEW["generate"]
    return [{"tokens": p} for p in prompts], new


def prompt_shape(batch) -> tuple:
    """(B, S) of a batch's prompt: its decoder tokens or its embeds."""
    return tuple((batch["tokens"] if "tokens" in batch
                  else batch["embeds"]).shape[:2])


def on_device(batch, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def decode_profile(torch, steps) -> dict:
    """One torch.profiler pass (device activity) over ``steps()``, a few
    synchronized decode steps: device time by the port's kernels and the
    rest, the busy share of the wall, and the ten kernels that take most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    top = sorted((ev for ev in prof.key_averages()
                  if ev.self_device_time_total),
                 key=lambda ev: -ev.self_device_time_total)[:10]
    return {"wall_ms": wall * 1e3,
            **device_time_by_kernel(prof, wall),
            "top_kernels": [{"name": ev.key[:160], "calls": ev.count,
                             "ms": ev.self_device_time_total / 1e3}
                            for ev in top]}


def family_run(torch, name, cfg, path, cim_ops, paged_ops, *,
               device="cuda", long_prompt=None, params=None,
               prompt_lens=FAMILY_MOE_PROMPTS):
    """One run of the families phase: serve ``cfg`` at its widths, gate it
    and time it.  ``path`` "generate" serves each prompt batch of
    ``family_batches`` by one Engine.generate call (greedy, int8 dense
    cache, the bf16 ring, or the recurrent states); "continuous" serves
    the main phase's 8 requests through a ContinuousEngine with chunked
    prefill of 64, paged attention and an int8 pool, then ``long_prompt``
    (if any) through Engine.generate.  The state-space and multimodal
    runs' prefill logits must equal the plain versions' bit for bit (K1 is
    exact and the rest is shared code); the multimodal runs also show
    their inputs live (first-token logits move when whisper's frames, or
    qwen2-vl's image positions, change).  A dense or encoder-decoder run
    is cut to the depth that fits the card's free memory
    (``fit_depth``).  ``params`` (frozen under ``family_plan``) replace
    the seed-0 weights; ``prompt_lens`` the decoder runs' prompts.
    Returns (result, launches, failures)."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch import prng
    from repro_torch.serve import ContinuousEngine, Engine, RequestStatus

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    plan = family_plan()
    if params is None:
        cfg, memory = fit_depth(torch, cfg, device)
        params, init_s = family_params(torch, cfg, plan, device,
                                       head_first=name in HEAD_FIRST)
    else:
        memory, init_s = None, 0.0
    per_pass = k1_per_pass(cfg)
    enc_k1, cross_k1 = k1_encoder(cfg)
    exact = name in BIT_IDENTICAL
    failures, runs = [], {}
    total = dict.fromkeys(read_launches(cim_ops, paged_ops), 0)
    pf_logits = {"kernel": [], "plain": [], "reorder": []}
    first_kernel, gated_prompts = [], []

    def served(tag, fn, n_prompts_tokens):
        """Run ``fn`` with the counts at 0; check K1 = passes x per_pass
        (+ the encoder passes' and cross K/V projections' launches)."""
        reset_launches(cim_ops, paged_ops)
        with counted_passes(T, M) as passes:
            sync()
            t0 = time.perf_counter()
            out, n_tok = fn()
            sync()
            wall = time.perf_counter() - t0
        launches = read_launches(cim_ops, paged_ops)
        for k, v in launches.items():
            total[k] += v
        extra = passes["encoder"] * enc_k1 + passes["cross_kv"] * cross_k1
        want = passes["stack"] * per_pass + extra
        if device == "cuda" and launches["cim_matmul"] != want:
            failures.append(f"{name}/{tag}: K1 launched "
                            f"{launches['cim_matmul']} times, not {want} "
                            f"({passes['stack']} passes x {per_pass} + "
                            f"{passes['encoder']} encoder passes x {enc_k1}"
                            f" + {passes['cross_kv']} cross K/V x "
                            f"{cross_k1})")
        runs[tag] = {"wall_s": wall, "tokens": n_tok,
                     "tokens_per_wall_s": n_tok / wall,
                     "prompt_tokens": n_prompts_tokens,
                     "passes": passes["stack"], "k1_per_pass": per_pass,
                     "k1_expected": want, "launches": launches,
                     "k1_per_layer_step": (
                         (launches["cim_matmul"] - passes["stack"] - extra)
                         / max(1, passes["stack"] * cfg.n_layers))}
        if enc_k1:
            runs[tag].update(encoder_passes=passes["encoder"],
                             cross_kv_passes=passes["cross_kv"],
                             k1_encoder_pass=enc_k1, k1_cross_kv=cross_k1)
        return out, passes

    def generate(batches, new):
        max_len = max(prompt_shape(b)[1] for b in batches) + new + 32
        eng = Engine(params, cfg, max_len=max_len, plan=plan, device=device)

        def fn():
            outs = [eng.generate(on_device(b, device),
                                 max_new_tokens=new).tokens.cpu()
                    for b in batches]
            return outs, sum(o.numel() for o in outs)

        outs, passes = served("generate", fn, sum(
            math.prod(prompt_shape(b)) for b in batches))
        # A prefill and ``new`` decode steps per call; an encoder pass and
        # one cross K/V projection per prefill.
        calls = len(batches)
        if passes["stack"] != calls * (new + 1):
            failures.append(f"{name}: {passes['stack']} stack passes, not "
                            f"{calls * (new + 1)}")
        if enc_k1 and (passes["encoder"], passes["cross_kv"]) != (calls,
                                                                  calls):
            failures.append(f"{name}: {passes['encoder']} encoder passes "
                            f"and {passes['cross_kv']} cross K/V, not "
                            f"{calls} each")
        prefill = eng.prefill_fn(plan)

        def last_logits(batch):
            return prefill(params, batch)[0][:, -1, :cfg.vocab].float()

        kernel_logits = []
        for b, o in zip(batches, outs):
            batch = eng.bucket(on_device(b, device))
            lk = last_logits(batch)
            kernel_logits.append(lk)
            with plain_versions(cim_ops, paged_ops):
                lp = last_logits(batch)
                # The state-space and multimodal runs are held to
                # bit-identity: a floor of 0, so logit_gate fails any
                # kernel-vs-plain difference.
                if exact:
                    lr = lp
                else:
                    with reordered_attention(attn_lib):
                        lr = last_logits(batch)
            rows, s = prompt_shape(b)
            for row in range(rows):
                pf_logits["kernel"].append(lk[row])
                pf_logits["plain"].append(lp[row])
                pf_logits["reorder"].append(lr[row])
                first_kernel.append(o[row])
                gated_prompts.append(s)
        # Liveness, one more prefill each: whisper's first-token logits
        # move with its frames, qwen2-vl's when the image prompt's
        # positions become text positions (the M-RoPE bands are live).
        live = None
        if enc_k1:
            b = on_device(batches[0], device)
            changed = dict(b, frames=family_inputs(
                torch, cfg, b["frames"].shape[:2], 99).to(device))
            live = ("frames", 0, last_logits(changed))
        elif cfg.mrope_sections is not None:
            i = next(i for i, b in enumerate(batches) if "positions" in b)
            changed = {"embeds": batches[i]["embeds"].to(device)}
            live = ("image positions -> text positions", i,
                    last_logits(changed))
        if live is not None:
            what, i, moved = live
            diff = (moved - kernel_logits[i]).abs().max().item()
            result["liveness"] = {
                "changed": what, "prompt_len": prompt_shape(batches[i])[1],
                "first_token_logit_max_abs_diff": diff,
                "first_token_changed": bool(
                    (moved.argmax(-1) != kernel_logits[i].argmax(-1)).any())}
            if not diff > 0:
                failures.append(f"{name}: first-token logits do not move "
                                f"when the {what} change")
        return eng

    result = {"phase": "families", "run": name, "arch": cfg.name,
              "path": path, "layers": cfg.n_layers,
              "published_layers": family_config(cfg.name, None).n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab,
              "sliding_window": cfg.sliding_window,
              "encoder_layers": cfg.n_enc_layers or None,
              "mrope_sections": cfg.mrope_sections,
              "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
              "init_s": init_s}
    if path == "generate":
        batches, new = family_batches(torch, cfg, prompt_lens)
        eng = generate(batches, new)
        step_batch = {k: v[:, :1] if k == "positions" else v[:1]
                      for k, v in batches[-1].items()}
    else:
        reqs = [dataclasses.replace(r, max_new=FAMILY_NEW["continuous"])
                for r in serving_requests(torch, cfg)]
        ce = ContinuousEngine(params, cfg, plan=plan, max_batch=8,
                              kv_blocks=512, block_size=16, segment_len=8,
                              paged_attn=True, chunked_prefill=True,
                              prefill_chunk=64, device=device)

        def fn():
            res = ce.run(reqs)
            return res, sum(len(r.tokens) for r in res.values())

        res, _ = served("continuous", fn, sum(r.prompt_len for r in reqs))
        bad = [rid for rid, r in res.items()
               if r.status is not RequestStatus.OK]
        if len(res) != len(reqs) or bad:
            failures.append(f"{name}: requests not OK: {bad}")
        for kname in ("paged_attention", "flash_prefill", "merge_splits"):
            if device == "cuda" and runs["continuous"]["launches"][kname] <= 0:
                failures.append(f"{name}: {kname} never launched")
        runs["continuous"]["segments"] = ce.last_run_segments
        runs["continuous"]["prefill_chunks"] = ce.last_run_prefill_chunks
        runs["continuous"]["peak_mem_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else None)
        kplan = ce.plan       # w8a8_kernel with paged attention
        for r in reqs:
            pf_logits["kernel"].append(chunked_prefill_logits(
                torch, params, cfg, r.prompt, kplan, chunk=64,
                device=device))
            with plain_versions(cim_ops, paged_ops):
                pf_logits["plain"].append(chunked_prefill_logits(
                    torch, params, cfg, r.prompt, kplan, chunk=64,
                    device=device))
                pf_logits["reorder"].append(chunked_prefill_logits(
                    torch, params, cfg, r.prompt,
                    dataclasses.replace(kplan, paged_attn=False), chunk=64,
                    device=device))
            first_kernel.append(torch.as_tensor(res[r.rid].tokens))
            gated_prompts.append(r.prompt_len)
        eng = None
        step_batch = {"tokens": torch.as_tensor(reqs[0].prompt)[None]}
        if long_prompt:
            eng = generate(
                [{"tokens": family_prompts(torch, cfg,
                                           (long_prompt,))[0][None]}],
                FAMILY_NEW["generate"])
    gate, gate_failures = logit_gate(
        torch, pf_logits, first_kernel,
        [[int(lp.argmax())] for lp in pf_logits["plain"]], run_floor=True)
    failures += [f"{name}: {f}" for f in gate_failures]

    # One decode step at batch 1 after the longest prompt (Engine.generate's
    # step over a dense cache), host clock around 8 synchronized steps.
    step_len = prompt_shape(step_batch)[1]
    eng = eng or Engine(params, cfg, max_len=step_len + 48, plan=plan,
                        device=device)
    step = eng.make_step(plan, True)
    logits, caches = eng.prefill_fn(plan)(
        params, eng.bucket(on_device(step_batch, device)))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    key = prng.PRNGKey(0, device=device)
    rids = torch.zeros(1, dtype=torch.int32, device=device)
    temp = torch.tensor(1.0, device=device)
    tok, _, _, caches = step(params, tok, caches, key, rids, 1, temp)
    sync()
    t0 = time.perf_counter()
    for t in range(8):
        tok, _, _, caches = step(params, tok, caches, key, rids, t + 2, temp)
    sync()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    if device == "cuda" and cfg.arch_type == "ssm":
        # Where a decode step's device time goes: the SSD's and the
        # block's PyTorch kernels against K1, and the busy share.
        def steps():
            nonlocal tok, caches
            for t in range(8):
                tok, _, _, caches = step(params, tok, caches, key, rids,
                                         t + 10, temp)
        result["decode_profile"] = decode_profile(torch, steps)
    published = family_config(cfg.name, None).n_layers
    result.update({
        "runs": runs, "gated_prompt_lens": gated_prompts,
        "decode_step_ms_b1": step_ms,
        "decode_step_prompt": step_len,
        "depth_cut": (None if cfg.n_layers == published
                      else f"{cfg.n_layers} of {published} layers"),
        "memory_check": memory,
        "k1_per_layer_step": k1_per_layer(cfg), "k1_per_pass": per_pass,
        "launches": total,
        **gate,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else None)})
    result["ok"] = not failures
    return result, total, failures


def families_path(torch, cim_ops, paged_ops, *, device="cuda", runs=None,
                  configs=None):
    """The families phase: each of FAMILY_RUNS (or ``runs``) in turn, its
    own line, params freed before the next.  ``configs`` maps a run's name
    to a config to use instead (a reduced one for a CPU rehearsal).
    Returns (lines, launches summed over the runs, failures)."""
    lines, total, failures = [], {}, []
    for name, arch, layers, path in runs or FAMILY_RUNS:
        t = time.perf_counter()
        cfg = (configs or {}).get(name) or family_config(arch, layers)
        result, launches, fails = family_run(
            torch, name, cfg, path, cim_ops, paged_ops, device=device,
            long_prompt=(FAMILY_LONG_PROMPT if name == "dense-d160"
                         else None))
        result["run_s"] = time.perf_counter() - t
        lines.append(result)
        failures += fails
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if device == "cuda":
            torch.cuda.empty_cache()
    return lines, total, failures


# ---------------------------------------------------------------------------
# The train phase: QAT training at full size, stop and resume, deploy
# ---------------------------------------------------------------------------

# granite-moe-1b-a400m at its published size (~1.385 B parameters: bf16
# params, f32 master/m/v and bf16 grads are ~22 GB), the JAX package's
# training default, under the qat plan; eight steps on one fixed batch of
# 8 x 256 tokens, then two more under the profiler.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 8
TRAIN_PROFILED_STEPS = 2
TRAIN_BATCH = (8, 256)
# Stop and resume at full width and 2 of 24 layers: one full-depth
# checkpoint is ~19.4 GB of npz, one at 2 layers ~2.9 GB.  Six steps
# straight, against three and a resume to six.
RESUME_LAYERS = 2
RESUME_STEPS = (3, 6)
# The trained model, frozen under w8a8_kernel, serves one Engine.generate
# call per prompt, 16 new tokens each.
DEPLOY_PROMPTS = (64, 128, 64, 128)
TRAIN_CHILD_MARK = "TRAIN_CHILD_RESULT "


def train_config(arch: str = TRAIN_ARCH):
    """The arch at its published size, ``linear_mode="qat"`` (the
    attention projections fake-quantized; the expert banks train as bf16
    einsums and the head exact, as in the JAX package) and an int8 KV
    cache for the serve step."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), linear_mode="qat",
                               kv_cache_dtype="int8")


def train_tcfg(**kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30, remat=True,
                       **kw)


def freeze_by_block(torch, params, plan, device) -> dict:
    """Trained master params frozen under ``plan`` one block at a time,
    each block's masters dropped as it is frozen."""
    from repro_torch.models import model as M
    blocks = params["stack"].pop("blocks")
    frozen = M.freeze_params({k: params.pop(k) for k in list(params)
                              if k != "stack"}, a_scale=0.05, plan=plan)
    frozen["stack"] = {"blocks": []}
    while blocks:
        one = {"stack": {"blocks": [blocks.pop(0)]}}
        frozen["stack"]["blocks"] += M.freeze_params(
            one, a_scale=0.05, plan=plan)["stack"]["blocks"]
        del one
    if device == "cuda":
        torch.cuda.empty_cache()
    return frozen


def resume_check(torch, cfg, device) -> tuple:
    """``train_loop.run`` at ``cfg``'s widths twice in a temporary
    directory: RESUME_STEPS[1] steps straight, and RESUME_STEPS[0] steps
    then a resume to RESUME_STEPS[1] (a checkpoint every RESUME_STEPS[0]
    steps).  Params, m, v, step and the resumed steps' losses must be
    equal bit for bit.  Returns (record, failures)."""
    import io
    import shutil
    import tempfile

    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop
    stop, total = RESUME_STEPS
    tcfg = train_tcfg(checkpoint_every=stop)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    failures = []
    # Two checkpoints a run: bf16 params and f32 master, m and v.
    ckpt_bytes = cfg.param_count() * (2 + 3 * 4)
    free = shutil.disk_usage(tmp).free
    record = {"layers": cfg.n_layers, "d_model": cfg.d_model,
              "depth_cut": (f"{cfg.n_layers} of "
                            f"{train_config(cfg.name).n_layers} layers: one "
                            "full-depth checkpoint is ~19.4 GB of npz"),
              "steps": total, "stopped_at": stop,
              "disk_free_gb": free / 1e9,
              "checkpoint_gb_estimate": ckpt_bytes / 1e9}
    try:
        if free < 4.4 * ckpt_bytes:
            raise MemoryError(f"{free / 1e9:.1f} GB of disk free, the two "
                              f"runs write ~{4 * ckpt_bytes / 1e9:.1f} GB")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            a = train_loop.run(cfg, tcfg, ckpt_dir=f"{tmp}/a", steps=total,
                               log_every=10**9, device=device)
            train_loop.run(cfg, tcfg, ckpt_dir=f"{tmp}/b", steps=stop,
                           log_every=10**9, device=device)
            b = train_loop.run(cfg, tcfg, ckpt_dir=f"{tmp}/b", steps=total,
                               log_every=10**9, device=device)
        record["runs_s"] = time.perf_counter() - t0
        step_dir = os.path.join(tmp, "b", f"step_{stop:09d}")
        record["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(step_dir, f))
            for f in os.listdir(step_dir)) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = {name: all(torch.equal(x, y) for x, y in zip(
                opt_lib.tree_leaves(ta), opt_lib.tree_leaves(tb)))
            for name, ta, tb in (
                ("params", a["params"], b["params"]),
                ("m", a["opt_state"]["m"], b["opt_state"]["m"]),
                ("v", a["opt_state"]["v"], b["opt_state"]["v"]),
                ("step", a["opt_state"]["step"], b["opt_state"]["step"]))}
    losses_a = [h["loss"] for h in a["history"]]
    losses_b = [h["loss"] for h in b["history"]]
    same["losses"] = losses_a[stop:] == losses_b
    record.update({"bit_identical": same, "losses_straight": losses_a,
                   "losses_resumed": losses_b,
                   "resumed_steps": [h["step"] for h in b["history"]]})
    if not all(same.values()):
        failures.append(f"train resume: not bit-identical to the run never "
                        f"stopped ({same})")
    return record, failures


def train_path(torch, cim_ops, paged_ops, *, device="cuda", cfg=None,
               resume_layers: int = RESUME_LAYERS):
    """The train phase at ``cfg``'s size (default: ``train_config()``).

    1. QAT training: params from ``model.init`` at seed 0 in the config's
       dtype, AdamW (lr 1e-3, 2 warmup steps, cosine to 30), every block
       rematerialized, under ``train_loop.deterministic`` and without
       TF32; TRAIN_STEPS steps on one fixed ``lm_batch`` of TRAIN_BATCH:
       every loss and grad norm finite and above 0, the last loss below
       the first (JAX's ``test_reduced_loss_decreases``).  Step ms,
       trained tokens per second, peak memory, and the device's busy
       share over TRAIN_PROFILED_STEPS more steps (``torch.profiler``).
    2. Deploy: the optimizer state freed, the trained params frozen
       block by block under ``family_plan()`` (w8a8_kernel, routers
       float) and served through Engine.generate by ``family_run``
       (DEPLOY_PROMPTS, 16 new, greedy): every request OK, K1 exactly
       stack passes x ``k1_per_pass``, kernel vs plain prefill logits
       under ``logit_gate``.
    3. Stop and resume at ``resume_layers`` layers (``resume_check``).

    Returns (result, K1 launches of the deploy step, failures)."""
    import statistics

    from repro_torch.data import synthetic
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = cfg or train_config()
    failures = []
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    tcfg = train_tcfg()
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=device).manual_seed(0),
                    device=device)
    opt = opt_lib.init_opt_state(params)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in opt_lib.tree_leaves(params))
    b, s = TRAIN_BATCH
    batch = synthetic.lm_batch(synthetic.TokenStreamConfig(cfg.vocab, s, b),
                               0, device=device)
    step = train_loop.make_train_step(cfg, tcfg)
    losses, gnorms, step_ms = [], [], []

    def one_step():
        nonlocal params, opt
        params, opt, m = step(params, opt, batch)
        return m

    profile = None
    with train_loop.deterministic():
        for _ in range(TRAIN_STEPS):
            sync()
            t = time.perf_counter()
            m = one_step()
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_ms.append((time.perf_counter() - t) * 1e3)
        if device == "cuda":
            def steps():
                for _ in range(TRAIN_PROFILED_STEPS):
                    one_step()
            profile = decode_profile(torch, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None
    bad = [i for i, (lo, gn) in enumerate(zip(losses, gnorms))
           if not (math.isfinite(lo) and lo > 0 and math.isfinite(gn)
                   and gn > 0)]
    if bad:
        failures.append(f"train: steps {bad} gave a loss or grad norm that "
                        "is not finite and above 0")
    if not losses[-1] < losses[0]:
        failures.append(f"train: the loss did not fall ({losses[0]} -> "
                        f"{losses[-1]})")
    med = statistics.median(step_ms[1:] or step_ms)
    result = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_kv_heads": cfg.n_kv_heads,
              "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
              "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
              "params": n_params, "dtype": cfg.dtype,
              "linear_mode": cfg.linear_mode, "batch": list(TRAIN_BATCH),
              "train_config": dataclasses.asdict(tcfg),
              "init_s": init_s, "losses": losses, "grad_norms": gnorms,
              "first_loss": losses[0], "ln_vocab": math.log(cfg.vocab),
              "loss_fell": losses[-1] < losses[0], "step_ms": step_ms,
              "median_step_ms": med,
              "tokens_per_s": b * s / (med / 1e3),
              "peak_mem_gb": peak, "profile": profile,
              "tf32": torch.backends.cuda.matmul.allow_tf32,
              "deterministic": True}

    # Deploy the trained model: the optimizer state goes first.
    del opt, step
    t = time.perf_counter()
    frozen = freeze_by_block(torch, params, family_plan(), device)
    del params
    serve_cfg = dataclasses.replace(cfg, linear_mode="exact")
    deploy, launches, fails = family_run(
        torch, "train-deploy", serve_cfg, "generate", cim_ops, paged_ops,
        device=device, params=frozen, prompt_lens=DEPLOY_PROMPTS)
    deploy["freeze_and_serve_s"] = time.perf_counter() - t
    result["deploy"] = deploy
    failures += fails
    del frozen
    if device == "cuda":
        torch.cuda.empty_cache()

    result["resume"], fails = resume_check(
        torch, dataclasses.replace(cfg, n_layers=resume_layers), device)
    failures += fails
    result["mesh_train"], fails = mesh_train_check(
        torch, device, None if device == "cuda" else dataclasses.replace(
            cfg, n_layers=MESH_TRAIN_LAYERS), TRAIN_BATCH)
    failures += fails
    result["launches"] = launches
    result["ok"] = not failures
    return result, launches, failures


def train_in_child(src: str) -> tuple:
    """The train phase in a child process with CUBLAS_WORKSPACE_CONFIG set
    before CUDA starts (deterministic cuBLAS), so the earlier phases run
    as they did.  The child's stderr passes through; a failed or silent
    child fails the phase.  Returns (result, launches, failures)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-child",
         "--src", src], env=env, stdout=subprocess.PIPE, text=True,
        timeout=900)
    line = next((ln for ln in reversed(proc.stdout.splitlines())
                 if ln.startswith(TRAIN_CHILD_MARK)), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"the train phase's child process failed (exit "
                             f"{proc.returncode}); its output ends: "
                             f"{proc.stdout[-2000:]}")
    out = json.loads(line[len(TRAIN_CHILD_MARK):])
    return out["result"], out["launches"], out["failures"]


# ---------------------------------------------------------------------------
# The distributed phase: the mesh paths on an NCCL group of one rank
# ---------------------------------------------------------------------------

DIST_MESH = (1, 1)                 # ("data", "model") on the one card
DIST_BATCH, DIST_PROMPT, DIST_NEW = 8, 32, 16
# Timed serves, without and with the mesh: a turn on the card's shared
# host can run 50 ms a step slow, and the median of 5 leaves two out.
DIST_TURNS = 5
# qwen3-8b's decode attention: B, H, KVH, D, S, valid positions.
DIST_ATTN = (8, 32, 8, 128, 4096, 3001)
DIST_PSUM_ELEMS = 16 * 2**20
# qwen3-8b's column-parallel linears at the production mesh's model = 16:
# (K, N) of q, k/v, gate/up and the head (padded vocab 152064 / 16).
K1_SHARD_SHAPES = ((4096, 256), (4096, 64), (4096, 768), (4096, 9504))
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 2


@contextlib.contextmanager
def process_group(torch, device):
    """A process group of one rank (nccl on the card, gloo on the CPU)
    over a FileStore in a temporary directory, destroyed on exit."""
    import tempfile

    from repro_torch.launch import mesh as mesh_lib
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_group(device, rank=0, world_size=1,
                            init_method=f"file://{tmp}/store")
        try:
            yield mesh_lib.make_mesh(DIST_MESH, device=device)
        finally:
            torch.distributed.destroy_process_group()


def check_k1_shards(torch, timer, ops, gen) -> list:
    """K1 at the column shards of qwen3-8b's linears on a model axis of
    16 (K1_SHARD_SHAPES) at M = 8 and 512: bit-exact against its plain
    version, timed beside its bound and the torch._int_mm yardstick."""
    dev = "cuda"
    a_scale = torch.tensor(0.05, device=dev)
    one = torch.tensor(1.0, device=dev)
    rows = []
    for k, n in K1_SHARD_SHAPES:
        w = rand_i8(torch, (k, n), gen, -127)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.zeros(n, device=dev)
        for m in (8, 512):
            a = torch.randn(m, k, generator=gen, device=dev)
            args = (a, w, a_scale, w_scale, bias, one)
            got = ops.cim_matmul_kernel(*args)
            want = ops.cim_matmul_plain(*args)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 not bit-exact at the shard shape "
                                     f"M={m} K={k} N={n}")
            rows.append({"M": m, "K": k, "N": n, "max_abs_err": 0.0,
                         "ms": timer.ms(lambda: ops.cim_matmul_kernel(
                             *args)),
                         **k1_times(torch, timer, ops, args)})
    return rows


def distributed_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                     cache=None):
    """The mesh paths at full width on a process group of one rank, in a
    ``DIST_MESH`` ("data", "model") DeviceMesh:

    1. serving: the serving phases' model (``cfg``, frozen under
       w8a8_kernel) through ``launch.serve.static_generate``, DIST_BATCH
       prompts of DIST_PROMPT tokens from PRNGKey(1), DIST_NEW new,
       greedy, without a mesh and then with the params laid out as
       DTensors by ``resolve_param_specs``: tokens equal, prefill logits
       bit-identical, K1 launch counts equal; wall times of the prefill
       alone and of the whole call give tok/s and the decode step;
    2. the collectives on the card's tensors: seq_parallel_decode_attention
       at qwen3-8b's decode shape against attend_decode (1e-5),
       compressed_psum on a DIST_PSUM_ELEMS gradient against its plain
       codec (codes and error equal), pipeline_forward with one stage
       equal to the stage;
    3. (on the card) K1 at the production mesh's shard shapes
       (``check_k1_shards``).

    Returns (result, K1 launches of the mesh serve, failures)."""
    from repro_torch.distributed import collectives, pipeline, sharding
    from repro_torch.launch.serve import static_generate
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as M
    from repro_torch import prng
    from repro_torch.train import compression

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    failures = []
    params, plan, init_s = frozen_params(torch, cfg, device, cache)
    prompts = prng.randint(prng.PRNGKey(1, device=device),
                           (DIST_BATCH, DIST_PROMPT), 0, cfg.vocab)
    max_len = DIST_PROMPT + DIST_NEW + 8
    result = {"phase": "distributed", "arch": cfg.name,
              "layers": cfg.n_layers, "mesh": dict(zip(("data", "model"),
                                                        DIST_MESH)),
              "batch": DIST_BATCH, "prompt": DIST_PROMPT, "new": DIST_NEW,
              "plan": "w8a8_kernel"}
    with process_group(torch, device) as mesh:
        result["backend"] = torch.distributed.get_backend()
        result["world_size"] = torch.distributed.get_world_size()

        def serve(p, new, m=None):
            sync()
            t0 = time.perf_counter()
            out = static_generate(p, cfg, prompts, new, max_len=max_len,
                                  plan=plan, mesh=m)
            sync()
            return out, time.perf_counter() - t0

        serve(params, 2)                        # warm-up, not counted
        _, pf_plain = serve(params, 1)
        reset_launches(cim_ops, paged_ops)
        (tok_a, lg_a), wall_a = serve(params, DIST_NEW)
        plain_counts = read_launches(cim_ops, paged_ops)
        t0 = time.perf_counter()
        shardings = sharding.resolve_param_specs(
            M.freeze_pspec(M.pspec(cfg), plan=plan), mesh)
        dparams = sharding.distribute(params, shardings)
        sync()
        result["distribute_s"] = time.perf_counter() - t0
        _, pf_mesh = serve(dparams, 1, mesh)
        reset_launches(cim_ops, paged_ops)
        (tok_b, lg_b), wall_b = serve(dparams, DIST_NEW, mesh)
        launches = read_launches(cim_ops, paged_ops)
        # A decode step is a DIST_NEW-token serve's wall less a one-token
        # serve's, over DIST_TURNS turns without and with the mesh (one
        # turn varies by tens of ms on the shared host); the median.
        steps = {"no_mesh": [], "mesh": []}
        for turn in range(DIST_TURNS):
            for tag, p, m in (("no_mesh", params, None),
                              ("mesh", dparams, mesh)):
                if turn == 0:
                    pf, wall = {"no_mesh": (pf_plain, wall_a),
                                "mesh": (pf_mesh, wall_b)}[tag]
                else:
                    pf, wall = serve(p, 1, m)[1], serve(p, DIST_NEW, m)[1]
                steps[tag].append((wall - pf) / (DIST_NEW - 1) * 1e3)
        del dparams
        total = DIST_BATCH * DIST_NEW
        result["serve"] = {
            "tokens_equal": bool(torch.equal(tok_a, tok_b)),
            "prefill_logits_bit_identical": bool(torch.equal(lg_a, lg_b)),
            "k1_launches_plain": plain_counts["cim_matmul"],
            "k1_launches_mesh": launches["cim_matmul"],
            "wall_s": {"no_mesh": wall_a, "mesh": wall_b},
            "tok_per_s": {"no_mesh": total / wall_a, "mesh": total / wall_b},
            "prefill_s": {"no_mesh": pf_plain, "mesh": pf_mesh},
            "decode_step_ms": {tag: statistics.median(v)
                               for tag, v in steps.items()},
            "decode_step_ms_turns": steps}
        sv = result["serve"]
        if not sv["tokens_equal"]:
            failures.append("distributed: mesh serve tokens differ from the "
                            "run without a mesh")
        if not sv["prefill_logits_bit_identical"]:
            diff = (lg_a - lg_b).abs().max().item()
            failures.append(f"distributed: mesh prefill logits differ (max "
                            f"{diff})")
        if launches["cim_matmul"] != plain_counts["cim_matmul"] or (
                device == "cuda" and launches["cim_matmul"] == 0):
            failures.append(f"distributed: K1 launched {launches} on the "
                            f"mesh, {plain_counts} without")

        # The collectives on the card's tensors.
        gen = torch.Generator(device=device).manual_seed(99)
        b, h, kvh, d, s, n_valid = DIST_ATTN
        q = torch.randn(b, 1, h, d, generator=gen, device=device)
        k = torch.randn(b, s, kvh, d, generator=gen, device=device)
        v = torch.randn(b, s, kvh, d, generator=gen, device=device)
        sync()
        t0 = time.perf_counter()
        got = collectives.seq_parallel_decode_attention(mesh, q, k, v,
                                                        n_valid)
        sync()
        attn_s = time.perf_counter() - t0
        want = attn_lib.attend_decode(
            q, k, v, (torch.arange(s, device=device) < n_valid)[None])
        err = (got - want).abs().max().item()
        g = torch.randn(DIST_PSUM_ELEMS, generator=gen, device=device)
        err0 = torch.zeros_like(g)
        sync()
        t0 = time.perf_counter()
        mean, new_err = compression.compressed_psum(g, err0, "data",
                                                    mesh=mesh)
        sync()
        psum_s = time.perf_counter() - t0
        codes, scale, plain_err = compression.compress(g, err0)
        w = torch.randn(1, 256, 256, generator=gen, device=device) / 16
        x = torch.randn(8, 4, 256, generator=gen, device=device)
        pipe = pipeline.pipeline_forward(
            mesh, lambda wt, xt: torch.tanh(xt @ wt), w, x, axis_name="data")
        pipe_want = torch.stack([torch.tanh(x[i] @ w[0]) for i in range(8)])
        result["collectives"] = {
            "seq_parallel_attention": {"shape": dict(zip(
                ("B", "H", "KVH", "D", "S", "valid"), DIST_ATTN)),
                "max_abs_err": err, "s": attn_s},
            "compressed_psum": {
                "elements": DIST_PSUM_ELEMS, "s": psum_s,
                "codes_equal": bool(torch.equal(
                    mean, compression.decompress(codes, scale))),
                "error_equal": bool(torch.equal(new_err, plain_err))},
            "pipeline_one_stage_equal": bool(torch.equal(pipe, pipe_want))}
        co = result["collectives"]
        if not err <= 1e-5:
            failures.append(f"distributed: seq-parallel decode attention "
                            f"off by {err}")
        if not (co["compressed_psum"]["codes_equal"]
                and co["compressed_psum"]["error_equal"]):
            failures.append("distributed: compressed_psum differs from its "
                            "plain codec")
        if not co["pipeline_one_stage_equal"]:
            failures.append("distributed: pipeline_forward differs from "
                            "its one stage")
    if device == "cuda":
        timer = Timer(torch)
        result["k1_shard_shapes"] = check_k1_shards(
            torch, timer, cim_ops, torch.Generator(device="cuda")
            .manual_seed(4321))
        del timer
    result["launches"] = launches
    result["ok"] = not failures
    return result, launches, failures


def mesh_train_check(torch, device, cfg=None, batch_shape=TRAIN_BATCH
                     ) -> tuple:
    """MESH_TRAIN_STEPS qat steps of ``train_config()`` at
    MESH_TRAIN_LAYERS layers from seed 0 on one fixed batch, without a
    mesh and on a DIST_MESH mesh of one rank (params, master, m and v
    DTensors laid out by ``resolve_param_specs``): params, m, v and the
    losses must be equal bit for bit.  Returns (record, failures)."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop

    cfg = cfg or dataclasses.replace(train_config(),
                                     n_layers=MESH_TRAIN_LAYERS)
    tcfg = train_tcfg()
    b, s = batch_shape
    batch = synthetic.lm_batch(synthetic.TokenStreamConfig(cfg.vocab, s, b),
                               0, device=device)

    def fresh():
        params = M.init(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
        return params, opt_lib.init_opt_state(params)

    def run(step, params, opt):
        losses = []
        t0 = time.perf_counter()
        for _ in range(MESH_TRAIN_STEPS):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        return params, opt, losses, time.perf_counter() - t0

    with train_loop.deterministic():
        p1, o1, l1, t1 = run(train_loop.make_train_step(cfg, tcfg), *fresh())
        with process_group(torch, device) as mesh:
            params, opt = fresh()
            sh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
            params = sharding.distribute(params, sh)
            opt = {**{k: sharding.distribute(opt[k], sh)
                      for k in ("master", "m", "v")}, "step": opt["step"]}
            p2, o2, l2, t2 = run(train_loop.make_train_step(
                cfg, tcfg, mesh=mesh), params, opt)

            def full(tree):
                return opt_lib.tree_map(lambda x: x.full_tensor(), tree)

            p2, m2, v2 = full(p2), full(o2["m"]), full(o2["v"])
    same = {name: all(torch.equal(x, y) for x, y in zip(
                opt_lib.tree_leaves(a), opt_lib.tree_leaves(c)))
            for name, a, c in (("params", p1, p2), ("m", o1["m"], m2),
                               ("v", o1["v"], v2))}
    same["losses"] = l1 == l2
    record = {"arch": cfg.name, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "linear_mode": cfg.linear_mode,
              "mesh": dict(zip(("data", "model"), DIST_MESH)),
              "steps": MESH_TRAIN_STEPS, "losses": l1, "losses_mesh": l2,
              "bit_identical": same, "s": t1, "s_mesh": t2}
    failures = [] if all(same.values()) else [
        f"mesh train: not bit-identical to the steps without a mesh "
        f"({same})"]
    return record, failures


# ---------------------------------------------------------------------------
# The VGG-8 deployment path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The dryrun phase: the production traces and their counts against the card
# ---------------------------------------------------------------------------

# (arch, shape, quant, layers kept (0: all), --act-shard) traced on the
# card's path over a fake 256-rank group.  granite-moe's train step is
# cut to 12 of its 24 layers: its trace costs ~3 s a layer on the card's
# host, and the whole cell (the sweep's, PERF.md) would take the phase
# past its 90 s.  qwen3-8b's train step, with and without the
# residual stream d-sharded between blocks, is cut to 4 of its 36 layers
# for the same reason (~25 s a layer).
DRYRUN_CELLS = (("qwen3-8b", "decode_32k", "w8a8", 0, False),
                ("granite-moe-1b-a400m", "train_4k", "none", 12, False),
                ("qwen3-8b", "train_4k", "none", 4, False),
                ("qwen3-8b", "train_4k", "none", 4, True))
# qwen3-8b decode_32k w8a8's temp bytes on rank 0, traced on the CPU
# path (``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
# decode_32k --mesh single --quant w8a8 --device cpu``): the card's
# trace holds it within DRYRUN_MEM_REL / DRYRUN_MEM_ABS (CUDA rounds each
# block up to 512 bytes).
DECODE_32K_CPU_TEMP = 213_995_809
# The JAX package's dry-run keys (``train`` cells add ``microbatches``);
# the port adds ``port``.
DRYRUN_KEYS = {"arch", "shape", "quant", "params", "active_params",
               "seq_len", "global_batch", "kind", "mesh", "kv_quant",
               "status", "lower_s", "compile_s", "n_chips",
               "flops_per_device", "traffic_bytes_per_device",
               "unknown_trip_loops", "top_ops", "xla_cost_flops",
               "xla_cost_bytes", "memory", "collectives", "port"}
# (kind, batch, KV length or prompt) of the counts held against a real step.
DRYRUN_CHECKS = (("decode", 8, 4096), ("prefill", 4, 2048))
# A dry-run child: ``launch.dryrun``'s CLI (argv[2:]) with the configs cut
# to the first argv[1] layers when argv[1] > 0 (widths unchanged).
DRYRUN_CHILD = """
import dataclasses, sys
from repro_torch import configs
from repro_torch.launch import dryrun
layers = int(sys.argv[1])
if layers:
    get = configs.get_config
    configs.get_config = lambda arch: dataclasses.replace(get(arch),
                                                          n_layers=layers)
dryrun.main(sys.argv[2:])
"""
DRYRUN_MEM_REL, DRYRUN_MEM_ABS = 0.05, 64 * 2**20


def dryrun_children(src: str, out_dir: str) -> list:
    """Start one ``launch.dryrun`` process per DRYRUN_CELLS cell (each
    holds its own fake group), all at once, their output in files under
    ``out_dir`` (a pipe left unread while the card check runs could
    fill)."""
    env = dict(os.environ, PYTHONPATH=src)
    procs = []
    for cell in DRYRUN_CELLS:
        arch, shape, quant, layers, act_shard = cell
        cmd = [sys.executable, "-c", DRYRUN_CHILD, str(layers), "--arch",
               arch, "--shape", shape, "--mesh", "single", "--quant", quant,
               "--device", "cuda", "--out", out_dir] \
            + (["--act-shard"] if act_shard else [])
        with open(dryrun_file(out_dir, cell, ".log"), "w") as f:
            procs.append((cell, time.perf_counter(),
                          subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                           stdout=f,
                                           stderr=subprocess.STDOUT)))
    return procs


def dryrun_file(out_dir: str, cell: tuple, suffix: str) -> pathlib.Path:
    """A dry-run child's log (``.log``) or the JSON its CLI writes
    (``.json``: ``launch.dryrun``'s file name)."""
    arch, shape, quant, _, act_shard = cell
    tag = "__actshard" if act_shard else ""
    if suffix == ".log":
        return pathlib.Path(out_dir) / f"{arch}__{shape}{tag}.log"
    return pathlib.Path(out_dir) / f"{arch}__{shape}__single__{quant}{tag}.json"


def act_shard_drop(cfg, res: dict, layers: int) -> float:
    """The temp bytes ``--act-shard`` takes off a train cell of ``cfg``
    cut to ``layers``: each block's remat carry, its rank's rows of a
    microbatch x seq x d in bf16, held as its d-chunk, (m - 1) / m of it
    (the 16 x 16 mesh: m = 16, 16 data ranks)."""
    m, dp = 16, 16
    rows = res["global_batch"] // dp // res["microbatches"]
    return layers * rows * res["seq_len"] * cfg.d_model * 2 * (m - 1) / m


# A constant, not measured here: the decode cell's figures in the port's
# earlier layout, its rows' caches whole over the sequence and the whole
# model gathered (GiB; PERF.md's sweep table), printed beside this run's.
WHOLE_SEQ_GIB_CONSTANT = {("qwen3-8b", "decode_32k", "w8a8"):
                          {"argument": 36.10, "temp": 5.77}}


def dryrun_cell_summary(res: dict, seconds: float, layers: int,
                        act_shard: bool) -> dict:
    k1 = res.get("port", {}).get("kernels", {}).get("cim_matmul", {})
    port = res.get("port", {})
    return {"arch": res["arch"], "shape": res["shape"],
            "quant": res["quant"], "status": res["status"],
            "layers": layers or "all", "act_shard": act_shard,
            "seconds": seconds, "lower_s": res.get("lower_s"),
            "compile_s": res.get("compile_s"),
            "flops_per_device": res.get("flops_per_device"),
            "traffic_bytes_per_device": res.get("traffic_bytes_per_device"),
            "memory": res.get("memory"),
            "jax_layout_argument_bytes": port.get(
                "jax_layout_argument_bytes"),
            "cache_seq_shard": port.get("cache_seq_shard"),
            "whole_seq_gib_constant": WHOLE_SEQ_GIB_CONSTANT.get(
                (res["arch"], res["shape"], res["quant"])),
            "collective_wire_bytes": sum(
                c["wire_bytes"] for c in res.get("collectives", {}).values()),
            "microbatches": res.get("microbatches"),
            "k1_records": k1.get("records", 0)}


def dryrun_card_check(torch, cfg, params, plan, kind, batch, length,
                      cim_ops, device="cuda") -> tuple:
    """One cell of the serving model on the card, traced on fake CUDA
    tensors and run for real under the same counter, both through the
    mesh path on a process group of one rank (``process_group``): the
    params laid out as DTensors and gathered one block at a time, a
    decode step's caches split as ``cache_specs`` lays them out
    (``spmd.split_caches``; one rank holds every position).  Returns
    (line, failures).  On ``device="cpu"`` (a rehearsal) the memory gate
    reads the real run's live bytes instead of the CUDA allocator."""
    with process_group(torch, device) as mesh:
        return _dryrun_card_check(torch, cfg, params, plan, kind, batch,
                                  length, cim_ops, device, mesh)


def _dryrun_card_check(torch, cfg, params, plan, kind, batch, length,
                       cim_ops, device, mesh) -> tuple:
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding, spmd
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.roofline import analysis

    shardings = sharding.resolve_param_specs(
        M.freeze_pspec(M.pspec(cfg), plan=plan), mesh)

    def inputs(dev):
        if kind == "decode":
            caches = spmd.split_caches(transformer.init_caches(
                cfg, batch, length, torch.bfloat16, device=dev), mesh, cfg)
            tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
            return ({"tokens": tokens}, caches)
        return ({"tokens": torch.zeros((batch, length), dtype=torch.int32,
                                       device=dev)},)

    step = (dryrun.decode_step_fn(cfg, plan, mesh) if kind == "decode"
            else dryrun.prefill_step_fn(cfg, length, plan, mesh))
    with FakeTensorMode(allow_non_fake_inputs=True):
        fparams = sharding.distribute(dryrun.fake_params(
            cfg, torch.device(device), plan, True), shardings)
        fargs = inputs(device)
        fake = dryrun.trace(lambda: step(fparams, *fargs))
    del fparams, fargs
    params = sharding.distribute(params, shardings)
    args = inputs(device)
    step(params, *args)                         # warm-up (cuBLAS, kernels)
    sync()
    del args
    args = inputs(device)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    launched = cim_ops.launches
    real = dryrun.trace(lambda: step(params, *args))
    sync()
    real_peak = (torch.cuda.max_memory_allocated() - before if on_card
                 else real["temp_bytes"])
    k1_launches = cim_ops.launches - launched
    del real["out"], args
    times = []
    for _ in range(3):
        args = inputs(device)
        sync()
        t0 = time.perf_counter()
        out = step(params, *args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        del out, args
    step_ms = sorted(times)[1]
    agg = fake["agg"]
    terms = analysis.roofline_terms(
        {"n_chips": 1, "flops_per_device": agg["flops"],
         "traffic_bytes_per_device": agg["traffic_bytes"],
         "collectives": agg["collectives"]}, model_flops=0.0, int8=True)
    bound_ms = max(terms.compute_s, terms.memory_s) * 1e3
    fk1 = agg["kernels"].get("cim_matmul", {}).get("records", 0)
    rk1 = real["agg"]["kernels"].get("cim_matmul", {}).get("records", 0)
    line = {"kind": kind, "batch": batch, "length": length,
            "layers": cfg.n_layers,
            "flops": {"fake": agg["flops"], "real": real["agg"]["flops"]},
            "traffic_bytes": {"fake": agg["traffic_bytes"],
                              "real": real["agg"]["traffic_bytes"]},
            "k1_records": {"fake": fk1, "real": rk1},
            "k1_launches": k1_launches,
            "temp_bytes": {"fake": fake["temp_bytes"],
                           "real_live": real["temp_bytes"],
                           "real_max_allocated": real_peak},
            "trace_s": fake["seconds"], "step_ms": step_ms,
            "step_ms_runs": times, "bound_ms": bound_ms,
            "bound_by": "operations" if terms.compute_s >= terms.memory_s
            else "bytes",
            "compute_ms": terms.compute_s * 1e3,
            "memory_ms": terms.memory_s * 1e3,
            "step_over_bound": step_ms / bound_ms}
    failures = []
    for key in ("flops", "traffic_bytes", "k1_records"):
        if line[key]["fake"] != line[key]["real"]:
            failures.append(f"dryrun {kind}: {key} of the real step "
                            f"{line[key]['real']} != the trace's "
                            f"{line[key]['fake']}")
    if fk1 != cfg.n_layers * 7 + 1:
        failures.append(f"dryrun {kind}: {fk1} K1 records, want "
                        f"{cfg.n_layers * 7 + 1}")
    if on_card and k1_launches != rk1:
        failures.append(f"dryrun {kind}: K1 launched {k1_launches} times "
                        f"for {rk1} records")
    gap = abs(fake["temp_bytes"] - real_peak)
    if gap > max(DRYRUN_MEM_REL * real_peak, DRYRUN_MEM_ABS):
        failures.append(f"dryrun {kind}: the trace's peak "
                        f"{fake['temp_bytes']} B is off the real step's "
                        f"max_memory_allocated delta {real_peak} B")
    return line, failures


def dryrun_path(torch, cfg, cim_ops, paged_ops, *, src=str(ROOT / "src"),
                cache=None):
    """The port's dry run on the card.

    1. ``launch.dryrun --device cuda`` traces DRYRUN_CELLS on rank 0 of
       the 16 x 16 production mesh over a fake 256-rank group (fake CUDA
       tensors, nothing allocated), one child process per cell, all
       started here at once: each writes JAX's keys (and ``port``), and
       qwen3-8b's decode records K1 on all 36 x 7 projections and the
       head, its temp within 5 % (or 64 MiB) of the CPU trace's
       (DECODE_32K_CPU_TEMP: the token lookup in the rank's d-shard of
       the table); qwen3-8b's train step with ``--act-shard`` has the
       flops of the one without and a temp lower by at least the
       blocks' remat carries' (m - 1) / m (``act_shard_drop``).
    2. Meanwhile, here: the distributed phase's qwen3-8b (``cfg``, all
       its layers, frozen under w8a8_kernel) at DRYRUN_CHECKS, one card,
       traced on fake tensors and run for real under the same counter:
       flops, traffic bytes and K1 records equal, K1's launches equal its
       records, the trace's peak within 5 % (or 64 MiB) of the real
       step's ``max_memory_allocated`` delta; the step's ms beside the
       roofline bound.
    Then the children are waited for (killed if they outlive the phase).

    Returns (result, launches, failures)."""
    import tempfile
    failures = []
    result = {"phase": "dryrun", "arch": cfg.name,
              "total_memory": torch.cuda.get_device_properties(0)
              .total_memory}
    with tempfile.TemporaryDirectory() as out_dir:
        procs = dryrun_children(src, out_dir)
        try:
            params, plan, _ = frozen_params(torch, cfg, "cuda", cache)
            reset_launches(cim_ops, paged_ops)
            checks = []
            for kind, batch, length in DRYRUN_CHECKS:
                line, fails = dryrun_card_check(torch, cfg, params, plan,
                                                kind, batch, length, cim_ops)
                checks.append(line)
                failures += fails
            result["card_check"] = checks
            launches = read_launches(cim_ops, paged_ops)
            cells, train = [], {}
            for spec, t0, proc in procs:
                arch, shape, quant, layers, act_shard = spec
                proc.wait(timeout=600)
                seconds = time.perf_counter() - t0
                out = dryrun_file(out_dir, spec, ".log").read_text()
                path = dryrun_file(out_dir, spec, ".json")
                if proc.returncode != 0 or not path.exists():
                    failures.append(f"dryrun: {arch} x {shape} failed "
                                    f"(exit {proc.returncode}): "
                                    f"{out[-1500:]}")
                    continue
                res = json.loads(path.read_text())
                cell = dryrun_cell_summary(res, seconds, layers, act_shard)
                cell["line"] = next((ln for ln in out.splitlines()
                                     if ln.startswith("[dryrun]")), None)
                cells.append(cell)
                want = DRYRUN_KEYS | ({"microbatches"}
                                      if res["kind"] == "train" else set())
                if set(res) != want:
                    failures.append(f"dryrun: {arch} x {shape} keys "
                                    f"{sorted(set(res) ^ want)} differ "
                                    "from JAX's")
                mem = res.get("memory", {})
                if res["kind"] == "decode" and mem.get("argument_bytes") \
                        != cell["jax_layout_argument_bytes"]:
                    failures.append(
                        f"dryrun: {arch} x {shape} holds "
                        f"{mem.get('argument_bytes')} argument bytes a rank,"
                        f" JAX's layout {cell['jax_layout_argument_bytes']}")
                if arch == "qwen3-8b" and res["kind"] == "decode":
                    if cell["k1_records"] != 36 * 7 + 1:
                        failures.append(
                            f"dryrun: qwen3-8b decode recorded "
                            f"{cell['k1_records']} K1 calls, want "
                            f"{36 * 7 + 1}")
                    # The shard-local lookup's temp, as the CPU trace.
                    temp = mem.get("temp_bytes", 0)
                    cell["cpu_trace_temp"] = DECODE_32K_CPU_TEMP
                    if abs(temp - DECODE_32K_CPU_TEMP) > max(
                            DRYRUN_MEM_REL * DECODE_32K_CPU_TEMP,
                            DRYRUN_MEM_ABS):
                        failures.append(
                            f"dryrun: qwen3-8b decode temp {temp} B, the "
                            f"CPU trace's {DECODE_32K_CPU_TEMP}")
                if arch == "qwen3-8b" and res["kind"] == "train":
                    train[act_shard] = (res, layers)
            if len(train) == 2:
                (off, layers), (on, _) = train[False], train[True]
                drop = off["memory"]["temp_bytes"] - \
                    on["memory"]["temp_bytes"]
                want = act_shard_drop(cfg, off, layers)
                result["act_shard"] = {
                    "layers": layers, "temp_drop": drop,
                    "carry_share": want,
                    "flops_equal": on["flops_per_device"]
                    == off["flops_per_device"]}
                if drop < want or not result["act_shard"]["flops_equal"]:
                    failures.append(f"dryrun: --act-shard took {drop} B "
                                    f"off qwen3-8b train_4k's temp (want "
                                    f">= {want:.0f}), flops equal: "
                                    f"{result['act_shard']['flops_equal']}")
            elif not failures:
                failures.append("dryrun: the qwen3-8b train_4k pair did "
                                "not run")
            result["production"] = cells
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    result["ok"] = not failures
    return result, launches, failures


def vgg8_path(torch, cim_ops, bs_ops, caat_ops, *, device="cuda", cfg=None,
              n_calib: int = 64, n_images: int = 64):
    """The paper's VGG-8 deployment (repro_torch.launch.fig10) at ``cfg``'s
    widths (default: the published VGG-8) with random weights from
    PRNGKey(0).
    Checks the kernel plans bit for bit against their plain plans, runs
    the cim plan raw and fine-tuned, and holds the CAAT macro op on every
    cim layer's int8 inputs against the behavioural simulation with an
    ideal ADC.  (``device``, ``cfg``, ``n_calib`` and ``n_images`` let it
    be rehearsed at a reduced size on CPU.)"""
    from repro_torch import prng
    from repro_torch.configs import vgg8_cifar10
    from repro_torch.core import adc, macro
    from repro_torch.core import backend as backend_lib
    from repro_torch.data import synthetic
    from repro_torch.launch import fig10
    from repro_torch.models import vgg

    cfg = cfg or vgg8_cifar10.config()
    failures = []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def key(seed):
        return prng.PRNGKey(seed, device=device)

    forward_s = {}

    def timed(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        forward_s[name] = time.perf_counter() - t
        if not bool(torch.isfinite(out).all()):
            failures.append(f"{name}: non-finite logits")
        return out

    t0 = time.perf_counter()
    params = vgg.init_vgg8(key(0), cfg)
    images, _ = synthetic.synthetic_cifar(key(99), n_images, cfg.n_classes,
                                          cfg.image_size)
    calib, _ = synthetic.synthetic_cifar(key(7), n_calib, cfg.n_classes,
                                         cfg.image_size)
    cim_ops.launches = bs_ops.launches = caat_ops.launches = 0
    a_scales = vgg.collect_activation_scales(params, calib, cfg)
    frozen = vgg.freeze_vgg8(params, cfg, a_scales, mode="w8a8")

    def forward(plan):
        return vgg.vgg8_forward(frozen, images, cfg, mode=plan,
                                a_scales=a_scales)

    expected = {}   # launches each kernel must show, per the path's shapes
    w8a8 = timed("w8a8", lambda: forward("w8a8"))
    expected["cim_matmul"] = 2 * len(vgg.VGG8_LAYER_PATHS)
    for residency in (False, True):
        plan = backend_lib.DeploymentPlan(default="w8a8_kernel",
                                          residency=residency)
        name = "w8a8_kernel" + ("+residency" if residency else "")
        if not torch.equal(timed(name, lambda: forward(plan)), w8a8):
            failures.append(f"{name} logits differ from plain w8a8")
    expected["bitplane_matmul"] = 8 * len(vgg.VGG8_LAYER_PATHS)
    bitserial = timed("bitserial", lambda: forward("bitserial"))
    if not torch.equal(timed("bitserial_kernel",
                             lambda: forward("bitserial_kernel")),
                       bitserial):
        failures.append("bitserial_kernel logits differ from plain "
                        "bitserial")
    # bitserial vs w8a8: equal up to the f32 shift-add rounding past 2**24;
    # a different argmax is a tie only inside that rounding.
    rounding = (bitserial - w8a8).abs().amax(-1)
    top2 = w8a8.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = bitserial.argmax(-1) != w8a8.argmax(-1)
    ties = differ & (gap <= 2 * rounding)
    if bool((differ & ~ties).any()):
        failures.append("bitserial argmax differs from w8a8 beyond the "
                        "shift-add rounding")

    # The cim plan: calibrated full scales, 8 sampled chips, per-channel
    # fine-tunes, at batch 32.
    d = fig10.deploy(params, cfg, "cim", calib, 0, device)
    cim_imgs = images[:32]
    stats_raw: list = []
    timed("cim_raw", lambda: fig10.batched_logits(
        d["raw"], cim_imgs, cfg, "cim", d["a_scales"], d["chips"], 32,
        stats_raw))
    calls = []
    sim = macro.cim_matmul_sim

    def recording_sim(a, w, chip, v_fs, mcfg, relu=True):
        calls.append((a, w, chip, v_fs, mcfg, relu))
        return sim(a, w, chip, v_fs, mcfg, relu=relu)

    stats_ft: list = []
    with swapped(macro, "cim_matmul_sim", recording_sim):
        ft = timed("cim_finetuned", lambda: fig10.batched_logits(
            d["finetuned"], cim_imgs, cfg, "cim", d["a_scales"], d["chips"],
            32, stats_ft))
    layers = fig10.layer_report("cim", cfg, stats_ft)
    # The CAAT macro op on each cim layer's actual int8 inputs: one launch
    # per row tile.
    expected["caat_mac"] = sum(-(-sp.in_dim // sp.macro.rows)
                               for sp in cfg.layer_specs())
    # Its device memory alone: the peak over the 8 calls, beside what was
    # allocated before them.
    cuda = device == "cuda"
    sync()
    phase_peak = torch.cuda.max_memory_allocated() if cuda else 0
    k5_base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    k5_codes = [caat_ops.cim_macro_matmul(a, w, chip, v_fs, mcfg, relu=relu)
                for a, w, chip, v_fs, mcfg, relu in calls]
    sync()
    k5_peak = torch.cuda.max_memory_allocated() if cuda else 0
    k5 = []
    for path, got, (a, w, chip, v_fs, mcfg, relu) in zip(
            vgg.VGG8_LAYER_PATHS, k5_codes, calls):
        ideal = {"caat": chip["caat"], "adc": adc.ideal_adc(mcfg.adc,
                                                              device)}
        want, _ = sim(a, w, ideal, v_fs, mcfg, relu=relu)
        try:
            k5.append({"layer": path, **code_diff(
                torch, got, want.to(torch.int32), f"K5 on {path}")})
        except AssertionError as e:
            failures.append(str(e))
    sync()
    launches = {"cim_matmul": cim_ops.launches,
                "bitplane_matmul": bs_ops.launches,
                "caat_mac": caat_ops.launches}
    if len(calls) != len(vgg.VGG8_LAYER_PATHS):
        failures.append(f"{len(calls)} cim layers recorded, not 8")
    for name, n in launches.items():
        if n != expected[name] and device == "cuda":
            failures.append(f"{name} launched {n} times on the vgg8 path, "
                            f"not {expected[name]}")
    result = {"phase": "vgg8",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "image_size": cfg.image_size, "images": n_images,
              "cim_images": int(cim_imgs.shape[0]),
              "seconds": time.perf_counter() - t0, "forward_s": forward_s,
              "launches": launches, "launches_expected": expected,
              "bitserial_vs_w8a8": {
                  "max_abs_logit_diff": float(rounding.max()),
                  "argmax_differs": int(differ.sum()),
                  "ties": int(ties.sum())},
              "cim_layers": layers,
              "cim_agree_with_w8a8": int(
                  (ft.argmax(-1) == w8a8[:32].argmax(-1)).sum()),
              "macro_energy_j": fig10.macro_energy_j(layers),
              "macro_energy_source": "65nm macro energy model of the "
                                     "fine-tuned cim forward's conversions",
              "k5_vs_sim": k5,
              "peak_mem_gb": (max(phase_peak,
                                  torch.cuda.max_memory_allocated()) / 1e9
                              if cuda else None),
              "k5_peak_mem_gb": k5_peak / 1e9 if cuda else None,
              "k5_base_mem_gb": k5_base / 1e9 if cuda else None}
    result["ok"] = not failures
    return result, launches, failures


PAPER_FIGS = ("fig7_capacitor_area", "fig7_energy", "fig8_breakdown",
              "table1_metrics", "fig9_nonlinearity")
# The JAX package's fig10_accuracy.main(steps=100, n_eval=192): the
# accuracy run's defaults.  K1 runs only in its w8a8_kernel evaluation,
# one launch per layer per batch of 64 eval images.
PAPER_N_EVAL = 192
PAPER_K1_LAUNCHES = 8 * -(-PAPER_N_EVAL // 64)


def paper_draws_card_vs_cpu(torch) -> dict:
    """One normal draw (2**20 at PRNGKey(3)) and the chip at PRNGKey(0),
    drawn on the card and on the CPU: how many elements differ, and by
    how much (reported, not gated)."""
    from repro_torch import prng
    from repro_torch.core import macro

    def diff(a, b):
        a, b = a.cpu(), b.cpu()
        return {"differ": int((a != b).sum()), "of": a.numel(),
                "max_abs": float((a - b).abs().max())}
    out = {"normal": diff(prng.normal(prng.PRNGKey(3, device="cuda"),
                                      (1 << 20,)),
                          prng.normal(prng.PRNGKey(3), (1 << 20,)))}
    cfg = macro.nominal_config()
    card = macro.sample_chip(prng.PRNGKey(0, device="cuda"), cfg)
    cpu = macro.sample_chip(prng.PRNGKey(0), cfg)
    for part in ("caat", "adc"):
        for name, v in card[part].items():
            out[f"chip_{name}"] = diff(v, cpu[part][name])
    return out


def paper_path(torch, cim_ops):
    """The paper's Fig. 7a, 7b, 8, Table I and Fig. 9 (200 CAAT chips, 50
    ADCs) through the port's entry points on the card, then the Fig. 10
    accuracy run at the JAX package's sizes and keys.  An entry point's
    failed claim raises out of here (the script exits non-zero)."""
    import importlib

    from repro_torch.launch import fig10

    failures = []
    seconds = {}
    values = {}
    cim_ops.launches = 0
    for name in PAPER_FIGS:
        t = time.perf_counter()
        res = importlib.import_module(f"repro_torch.launch.{name}").main(
            "cuda")
        seconds[name] = time.perf_counter() - t
        values[name] = {k: v for k, v in res.items()
                        if k not in ("rows", "bits", "adc_max_inl")}
        if name == "fig9_nonlinearity":
            values[name]["adc_max_inl_max"] = max(res["adc_max_inl"])
    t = time.perf_counter()
    acc = fig10.accuracy_run(device="cuda", n_eval=PAPER_N_EVAL)
    seconds["fig10"] = time.perf_counter() - t
    launches = {"cim_matmul": cim_ops.launches}
    if launches["cim_matmul"] != PAPER_K1_LAUNCHES:
        failures.append(f"K1 launched {launches['cim_matmul']} times on "
                        f"the paper path, not {PAPER_K1_LAUNCHES}")
    t = time.perf_counter()
    draws = paper_draws_card_vs_cpu(torch)
    seconds["card_vs_cpu"] = time.perf_counter() - t
    result = {"phase": "paper", "device": torch.cuda.get_device_name(0),
              "source": "65nm macro model (Fig. 7-9, Table I); trained "
                        "VGG-8 on synthetic CIFAR-like data (Fig. 10)",
              "figures": values,
              "fig10": {k: v for k, v in acc.items() if k != "rows"},
              "k1_launches": launches["cim_matmul"],
              "k1_expected": PAPER_K1_LAUNCHES,
              "draws_card_vs_cpu": draws, "seconds": seconds,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    result["ok"] = not failures
    return result, launches, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated serving phases to run after the "
                         "kernel checks (e.g. families), the rest skipped")
    ap.add_argument("--runs", default=None,
                    help="comma-separated runs of the families phase "
                         "(e.g. encdec,mrope), the rest skipped")
    ap.add_argument("--k5-only", action="store_true",
                    help="only time the whole CAAT macro op at every "
                         "VGG-8 shape")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch package is driven "
                         "(with --k5-only: another tree's op)")
    ap.add_argument("--train-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    # Segments that grow in place: the families phase holds qwen2-vl-72b's
    # ~74 GB of weights, frozen block by block beside f32 temporaries of
    # other sizes, which fixed segments leave fragmented (~7.5 GiB reserved
    # but unusable at 76 of its 80 blocks).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.bitserial_matmul import ops as bs_ops
    from repro_torch.kernels.caat_mac import ops as caat_ops
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train_child:    # the kernels were built by the parent
        result, launches, failures = train_path(torch, cim_ops, paged_ops)
        print(TRAIN_CHILD_MARK + json.dumps(
            {"result": result, "launches": launches, "failures": failures}),
            flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"nvidia_smi": smi}

    if args.k5_only:   # builds the one kernel at its first launch
        emit({"phase": "k5_whole_op", "src": args.src, "nvidia_smi": smi,
              "shapes": k5_whole_op_ms(
                  torch, Timer(torch), caat_ops,
                  torch.Generator(device="cuda").manual_seed(1234))})
        return 0
    build_s = build.build_all()
    report["ptxas"] = build.BUILD_LOG
    report["build"] = {"phase": "build", "seconds": build_s,
                       "sources": list(build.SOURCES),
                       "seconds_by_source": build.BUILD_SECONDS}
    emit(report["build"])

    gen = torch.Generator(device="cuda").manual_seed(1234)
    timer = Timer(torch)
    kernels = []
    for check, ops in ((check_k1, cim_ops), (check_k2, paged_ops),
                       (check_merge, paged_ops), (check_k3, paged_ops),
                       (check_k4, bs_ops), (check_k5, caat_ops)):
        t = time.perf_counter()
        entry = check(torch, timer, ops, gen)
        entry["check_s"] = time.perf_counter() - t
        kernels.append(entry)
        emit({"phase": "kernel", **entry})
    # The model families' shapes: K1 at every new (K, N), K2 and K3 at G
    # = 1 and D = 160.
    t = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    by_name["cim_matmul"]["family_shapes"] = family_k1(torch, timer,
                                                       cim_ops, gen)
    k2_rows, k3_rows = family_attention(torch, timer, paged_ops, gen)
    for kernel, rows in (("paged_attention", k2_rows),
                         ("flash_prefill", k3_rows)):
        by_name[kernel]["family_shapes"] = rows
        by_name[kernel]["max_abs_err_family"] = max(r["max_abs_err"]
                                                    for r in rows)
    emit({"phase": "kernel_family", "check_s": time.perf_counter() - t,
          "cim_matmul": by_name["cim_matmul"]["family_shapes"],
          "paged_attention": k2_rows, "flash_prefill": k3_rows})
    del timer

    # Launches by path: each path is driven with every count set to 0
    # just before it and read just after.
    by_path = {}
    if not args.skip_main:
        from repro_torch import configs
        qwen = dataclasses.replace(configs.get_config("qwen3-8b"),
                                   kv_cache_dtype="int8")
        serving = dataclasses.replace(qwen, n_layers=SERVE_LAYERS)
        # The serving phases share one model, made in the first; the
        # distributed and dryrun phases another at all 36 layers.
        served: dict = {}
        paths = (
            ("main", lambda: main_path(torch, serving, cim_ops, paged_ops,
                                       cache=served)),
            ("autotune", lambda: autotune_path(torch, serving, cim_ops,
                                               paged_ops)),
            ("static", lambda: static_path(torch, serving, cim_ops,
                                           paged_ops, cache=served)),
            ("blocking", lambda: blocking_path(torch, serving, cim_ops,
                                               paged_ops, cache=served)),
            ("durable", lambda: durable_path(torch, serving, cim_ops,
                                             paged_ops, cache=served)),
            ("distributed", lambda: distributed_path(
                torch, qwen, cim_ops, paged_ops, cache=served)),
            ("dryrun", lambda: dryrun_path(torch, qwen, cim_ops, paged_ops,
                                           src=args.src, cache=served)),
            ("families", lambda: families_path(
                torch, cim_ops, paged_ops,
                runs=[r for r in FAMILY_RUNS
                      if args.runs is None or r[0] in args.runs.split(",")])),
            ("train", lambda: train_in_child(args.src)),
            ("vgg8", lambda: vgg8_path(torch, cim_ops, bs_ops, caat_ops)),
            ("paper", lambda: paper_path(torch, cim_ops)))
        only = set(args.only.split(",")) if args.only else None
        for path, drive in paths:
            if only is not None and path not in only:
                continue
            if path == "families":
                served.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            result, by_path[path], failures = drive()
            # The families phase prints one line per run.
            lines = result if isinstance(result, list) else [result]
            lines[-1]["phase_s"] = time.perf_counter() - t
            for line in lines:
                line["nvidia_smi"] = smi
                emit(line)
            report[path] = result
            if path == "distributed":
                by_name["cim_matmul"]["shard_shapes"] = result[
                    "k1_shard_shapes"]
            if failures:
                (out_dir / "chip_smoke.json").write_text(
                    json.dumps(report, indent=1))
                raise AssertionError("; ".join(failures))
    for k in kernels:
        counts = {p: c[k["name"]] for p, c in by_path.items()
                  if k["name"] in c}
        k["launches"] = sum(counts.values()) if counts else None
        k["launches_by_path"] = counts
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
