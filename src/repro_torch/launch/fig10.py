"""The paper's VGG-8 CiM deployment (Fig. 10) on the PyTorch port: the
deploy half of the JAX package's ``benchmarks/fig10_accuracy.py``, without
training.

Usage:
  python -m repro_torch.launch.fig10 [--plan cim] [--eval 64] [--seed 0] \\
      [--device cpu]

VGG-8 at its published widths (32x32x3 input, six 3x3 convs of 128-512
channels, fc1 8192->1024, head 1024->10) with random weights from
``--seed``, on synthetic CIFAR-like images:

1. ``collect_activation_scales`` on 64 calibration images and
   ``calibrate_v_fs`` on 32 of them;
2. one sampled chip per layer (Fig. 9 nominal non-idealities);
3. ``freeze_vgg8`` under the plan (a backend name, inline JSON or a JSON
   file); where the plan deploys ``cim`` layers, also the per-channel
   output fine-tune of every cim layer and a second, fine-tuned freeze;
4. the forward over ``--eval`` images, at batch 32 for a plan with cim
   layers and 64 otherwise.

It prints one JSON line: argmax agreement with the exact (float) model,
per-layer conversion statistics, and the modelled energy of those
conversions on the 65nm macro (``core/energy.py``: a model of the
silicon, not a measurement of anything).  The weights are random, so the
paper's accuracy ordering is not asserted here; it needs the training
slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import vgg8_cifar10
from repro_torch.core import backend as backend_lib
from repro_torch.core import calibration, energy, executor, macro
from repro_torch.data import synthetic
from repro_torch.models import vgg


def fit_layer_finetunes(params, frozen, cfg, a_scales, chips, calib_imgs,
                        plan) -> list:
    """Per-channel mean/std matching between the ideal (w8a8) and the chip
    output of every cim layer of ``plan``, in one calibration inference
    along the ideal activation stream (paper section II.C).  None for the
    plan's other layers."""
    specs = vgg.resolve_specs(cfg, plan)
    fts = []

    def fit(li, flat):
        spec_i = dataclasses.replace(specs[li], mode="w8a8")
        ideal = executor.apply(executor.freeze(params[li], spec_i,
                                               a_scales[li]), flat, spec_i)
        if specs[li].mode == "cim":
            raw = executor.apply(frozen[li], flat, specs[li], chip=chips[li])
            fts.append(calibration.fit_finetune(ideal, raw, "per_channel"))
        else:
            fts.append(None)
        return ideal.to(torch.float32)

    x = calib_imgs
    li = 0
    for conv_i, cout in enumerate(vgg.VGG8_CHANNELS):
        patches = vgg._im2col(x)
        b, h, w, pdim = patches.shape
        x = fit(li, patches.reshape(b * h * w, pdim)).reshape(b, h, w, cout)
        if vgg.POOL_AFTER[conv_i]:
            x = vgg._maxpool2(x)
        li += 1
    x = fit(li, x.reshape(x.shape[0], -1))
    fit(li + 1, x)
    return fts


def batched_logits(frozen, images, cfg, plan, a_scales, chips, bs,
                   stats=None) -> torch.Tensor:
    """The deployed forward over ``images`` in batches of ``bs``."""
    return torch.cat([
        vgg.vgg8_forward(frozen, images[i:i + bs], cfg, mode=plan,
                         a_scales=a_scales, chips=chips, stats=stats)
        for i in range(0, images.shape[0], bs)])


def layer_report(plan, cfg, stats) -> list[dict]:
    """Per-layer conversion statistics summed over the forward's batches,
    beside the layer's backend."""
    specs = vgg.resolve_specs(cfg, plan)
    n = len(specs)
    out = []
    for li, (path, spec) in enumerate(zip(vgg.VGG8_LAYER_PATHS, specs)):
        mine = stats[li::n]
        convs = sum(float(s["n_conversions"]) for s in mine)
        neg = sum(float(s["neg_fraction"]) * float(s["n_conversions"])
                  for s in mine) / max(convs, 1.0)
        out.append({"layer": path, "backend": spec.mode,
                    "n_conversions": convs, "neg_fraction": neg,
                    "relu_fused": float(mine[0]["relu_fused"]),
                    "n_passes": float(mine[0]["n_passes"])})
    return out


def macro_energy_j(layers: list[dict]) -> float:
    """Modelled energy of the forward's conversions on the 65nm macro."""
    return sum(energy.workload_energy_joules(
        l["n_conversions"], neg_fraction=l["neg_fraction"],
        relu_fused=bool(l["relu_fused"])) for l in layers)


def deploy(params, cfg, plan, calib_imgs, seed: int, device) -> dict:
    """Calibrate, sample the chips and freeze under ``plan`` (raw and,
    where the plan has cim layers, fine-tuned)."""
    a_scales = vgg.collect_activation_scales(params, calib_imgs, cfg)
    v_fs = vgg.calibrate_v_fs(params, cfg, a_scales, calib_imgs[:32])
    mcfg = macro.nominal_config(rows=cfg.macro_rows)
    chips = [macro.sample_chip(
        torch.Generator(device=device).manual_seed(seed + 100 + i), mcfg)
        for i in range(len(vgg.VGG8_LAYER_PATHS))]
    raw = vgg.freeze_vgg8(params, cfg, a_scales, chips=chips, mode=plan,
                          v_fs_list=v_fs)
    out = {"a_scales": a_scales, "v_fs": v_fs, "chips": chips, "raw": raw,
           "finetunes": None, "finetuned": None}
    if any(s.mode == "cim" for s in vgg.resolve_specs(cfg, plan)):
        fts = fit_layer_finetunes(params, raw, cfg, a_scales, chips,
                                  calib_imgs, plan)
        out["finetunes"] = fts
        out["finetuned"] = vgg.freeze_vgg8(params, cfg, a_scales,
                                           chips=chips, finetunes=fts,
                                           mode=plan, v_fs_list=v_fs)
    return out


def run(plan, *, device="cuda", n_eval: int = 64, seed: int = 0,
        cfg: vgg.Vgg8Config | None = None, n_calib: int = 64) -> dict:
    """The whole deploy flow; returns the printed result.  ``cfg`` and
    ``n_calib`` let tests run it at a reduced size."""
    dev = device_lib.resolve(device)
    plan = backend_lib.as_plan(plan)
    cfg = cfg or vgg8_cifar10.config()

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    params = vgg.init_vgg8(gen(0), cfg)
    eval_imgs, eval_labels = synthetic.synthetic_cifar(
        gen(99), n_eval, cfg.n_classes, cfg.image_size)
    calib_imgs, _ = synthetic.synthetic_cifar(
        gen(7), n_calib, cfg.n_classes, cfg.image_size)
    exact = batched_logits(params, eval_imgs, cfg, "exact", None, None, 64)
    d = deploy(params, cfg, plan, calib_imgs, seed, dev)
    sync()
    setup_s = time.perf_counter() - t0

    has_cim = d["finetuned"] is not None
    bs = 32 if has_cim else 64
    result = {"plan": json.loads(plan.to_json()), "device": str(dev),
              "n_eval": n_eval, "batch": bs, "seed": seed,
              "setup_s": setup_s}
    ref = exact.argmax(-1)
    result["correct"] = {"exact": int((ref == eval_labels).sum())}
    result["agree_with_exact"] = {}
    runs = [("raw", d["raw"])]
    if has_cim:
        runs.append(("finetuned", d["finetuned"]))
    for name, frozen in runs:
        stats: list = []
        sync()
        t1 = time.perf_counter()
        logits = batched_logits(frozen, eval_imgs, cfg, plan, d["a_scales"],
                                d["chips"], bs, stats)
        sync()
        result[f"{name}_forward_s"] = time.perf_counter() - t1
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite {name} logits")
        top = logits.argmax(-1)
        result["agree_with_exact"][name] = int((top == ref).sum())
        result["correct"][name] = int((top == eval_labels).sum())
        layers = layer_report(plan, cfg, stats)
        result[f"{name}_layers"] = layers
    result["macro_energy_j"] = macro_energy_j(layers)
    result["macro_energy_source"] = (
        "65nm macro energy model (core/energy.py) of this forward's "
        "conversions; not a measurement")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan", default="cim",
                    help="DeploymentPlan: backend name, inline JSON, or path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--eval", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    result = run(backend_lib.load_plan(args.plan), device=args.device,
                 n_eval=args.eval, seed=args.seed)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
