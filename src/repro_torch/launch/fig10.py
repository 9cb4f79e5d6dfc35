"""The paper's VGG-8 CiM deployment and accuracy (Fig. 10) on the PyTorch
port: the JAX package's ``benchmarks/fig10_accuracy.py``.

Usage:
  python -m repro_torch.launch.fig10 [--plan cim] [--eval 64] [--seed 0] \\
      [--device cpu]
  python -m repro_torch.launch.fig10 --train-steps 100 [--eval 192] \\
      [--device cpu]

With ``--train-steps N`` (N > 0) it runs the accuracy experiment as the
JAX package's ``main`` does, at JAX's keys: ``train_vgg`` from
``PRNGKey(0)`` (Adam, N steps of 64 synthetic images), eval images at
``PRNGKey(99)``, 64 calibration images at ``PRNGKey(7)``, the 8 chips at
``PRNGKey(100 + i)``; it prints JAX's four accuracy rows (exact, w8a8,
cim raw, cim fine-tuned) and asserts JAX's two claims: the exact model
above 0.6, and the fine-tune not below the raw chips by more than 0.01.
The w8a8 accuracy is taken through the ``w8a8_kernel`` plan (K1 on the
card), whose logits must equal the plain ``w8a8`` plan's.  CIFAR-10 is
not available offline, so this is the paper's mechanism on synthetic
data, not its absolute numbers.

With ``--train-steps 0`` (the default) it runs the deploy half, without
training: VGG-8 at its published widths (32x32x3 input, six 3x3 convs of
128-512 channels, fc1 8192->1024, head 1024->10) with random weights from
``PRNGKey(--seed)``, on synthetic CIFAR-like images:

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
paper's accuracy ordering is not asserted by this half.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import prng
from repro_torch.configs import vgg8_cifar10
from repro_torch.core import backend as backend_lib
from repro_torch.core import calibration, energy, executor, macro
from repro_torch.data import synthetic
from repro_torch.launch.common import emit
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


def deploy(params, cfg, plan, calib_imgs, seed: int, device, *,
           a_scales=None) -> dict:
    """Calibrate, sample the chips (one per layer at ``PRNGKey(seed +
    100 + i)``, as the JAX package's ``main`` draws them at seed 0) and
    freeze under ``plan`` (raw and, where the plan has cim layers,
    fine-tuned)."""
    if a_scales is None:
        a_scales = vgg.collect_activation_scales(params, calib_imgs, cfg)
    v_fs = vgg.calibrate_v_fs(params, cfg, a_scales, calib_imgs[:32])
    mcfg = macro.nominal_config(rows=cfg.macro_rows)
    chips = [macro.sample_chip(prng.PRNGKey(seed + 100 + i, device=device),
                               mcfg) for i in range(len(vgg.VGG8_LAYER_PATHS))]
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


def _const(value: float, dtype) -> float:
    """A Python scalar as JAX casts it to a weakly typed operand's dtype."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def adam_update(params, m, v, grads, t: int, lr: float):
    """``benchmarks/fig10_accuracy.py``'s Adam update of step ``t`` (beta
    0.9 / 0.999, bias corrected, 1e-8 outside the square root) on lists
    of leaf dicts, op by op in each leaf's own dtype, the step's scalars
    cast to it as JAX casts a Python scalar: a bf16 leaf's update rounds
    at every op, as XLA:CPU's does, and an f32 leaf's moments fuse their
    first product into the sum, as XLA:CPU's do; each equals JAX's for the
    same gradient.  Returns the new (params, m, v)."""
    # JAX's 0.9 ** t and 0.999 ** t: a weakly typed f32 power.
    bc1 = float(np.float32(1.0) - np.float32(0.9) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(0.999) ** np.float32(t))
    new_p, new_m, new_v = [], [], []
    for p, mm, vv, gg in zip(params, m, v, grads):
        out = ({}, {}, {})
        for k, x in p.items():
            g = gg[k]

            def c(value):
                return _const(value, x.dtype)
            if x.dtype == torch.float32:
                # XLA:CPU fuses the first product into the sum (one
                # rounding; the f32 product is exact in float64).
                m1 = (mm[k].double() * c(0.9) + c(0.1) * g).float()
                v1 = (vv[k].double() * c(0.999) + c(0.001) * g * g).float()
            else:
                m1 = c(0.9) * mm[k] + c(0.1) * g
                v1 = c(0.999) * vv[k] + c(0.001) * g * g
            root = torch.sqrt((v1 / c(bc2)).to(torch.float64)).to(
                torch.float32).to(x.dtype)
            out[0][k] = x - c(lr) * (m1 / c(bc1)) / (root + c(1e-8))
            out[1][k] = m1
            out[2][k] = v1
        new_p.append(out[0])
        new_m.append(out[1])
        new_v.append(out[2])
    return new_p, new_m, new_v


def loss_and_grads(params, images, labels, cfg):
    """Mean cross-entropy of the exact forward (bf16 weights and
    activations, as the config's specs compute) and its gradients in the
    leaves' dtypes, from autograd."""
    leaves = [{k: x.detach().requires_grad_() for k, x in p.items()}
              for p in params]
    logits = vgg.vgg8_forward(leaves, images, cfg, mode="exact")
    onehot = torch.nn.functional.one_hot(labels, cfg.n_classes).to(
        torch.float32)
    loss = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot, -1))
    flat = [x for p in leaves for x in p.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return float(loss.detach()), [{k: next(grads) for k in p} for p in leaves]


def train_vgg(key, cfg, steps: int = 120, batch: int = 64,
              lr: float = 2e-3, losses: list | None = None) -> list[dict]:
    """``benchmarks/fig10_accuracy.py:train_vgg``: VGG-8 from
    ``init_vgg8(key)``, trained with Adam (beta 0.9 / 0.999, bias
    corrected, 1e-8 outside the square root) on the mean cross-entropy
    of the exact forward, step ``t`` on ``synthetic_cifar(fold_in(key,
    t), batch)``, gradients from autograd.  ``key`` is a ``prng``
    key (or a JAX key's data); the draws land on its device.

    JAX draws the training images at 32x32 whatever ``cfg.image_size`` is;
    here they are drawn at ``cfg.image_size``, so the two agree at 32.
    Each step's loss is appended to ``losses`` when given."""
    key = prng.as_key(key)
    params = vgg.init_vgg8(key, cfg)
    m = [{k: torch.zeros_like(x) for k, x in p.items()} for p in params]
    v = [{k: torch.zeros_like(x) for k, x in p.items()} for p in params]
    for t in range(1, steps + 1):
        images, labels = synthetic.synthetic_cifar(
            prng.fold_in(key, t), batch, cfg.n_classes, cfg.image_size)
        loss, grads = loss_and_grads(params, images, labels, cfg)
        with torch.no_grad():
            params, m, v = adam_update(params, m, v, grads, t, lr)
        if losses is not None:
            losses.append(loss)
    return params


def accuracy(logits_fn, images, labels, bs: int = 64) -> float:
    """Top-1 accuracy of ``logits_fn`` over ``images`` in batches of
    ``bs``."""
    correct = 0
    for i in range(0, images.shape[0], bs):
        logits = logits_fn(images[i:i + bs])
        correct += int((logits.argmax(-1) == labels[i:i + bs]).sum())
    return correct / images.shape[0]


def accuracy_run(*, device="cuda", steps: int = 100, n_eval: int = 192,
                 batch: int = 64, n_calib: int = 64,
                 cfg: vgg.Vgg8Config | None = None,
                 check_claims: bool = True) -> dict:
    """The JAX package's ``fig10_accuracy.main(steps, n_eval)`` at its
    keys: train, calibrate, deploy w8a8 and cim (raw and per-channel
    fine-tuned), print JAX's four accuracy rows and assert its claims
    (``check_claims=False`` reports them only).  ``batch``, ``n_calib``
    and ``cfg`` let tests run it at a reduced size."""
    dev = device_lib.resolve(device)
    cfg = cfg or vgg.Vgg8Config(macro_rows=1152)

    def key(seed):
        return prng.PRNGKey(seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    seconds = {}
    t0 = time.perf_counter()
    losses: list = []
    params = train_vgg(key(0), cfg, steps=steps, batch=batch, losses=losses)
    sync()
    seconds["train"] = time.perf_counter() - t0
    eval_imgs, eval_labels = synthetic.synthetic_cifar(
        key(99), n_eval, cfg.n_classes, cfg.image_size)
    calib_imgs, _ = synthetic.synthetic_cifar(
        key(7), n_calib, cfg.n_classes, cfg.image_size)

    t1 = time.perf_counter()
    acc_exact = accuracy(
        lambda x: vgg.vgg8_forward(params, x, cfg, mode="exact"),
        eval_imgs, eval_labels)
    a_scales = vgg.collect_activation_scales(params, calib_imgs, cfg)
    frozen_q = vgg.freeze_vgg8(params, cfg, a_scales, mode="w8a8")

    def w8a8_logits(plan):
        return batched_logits(frozen_q, eval_imgs, cfg, plan, a_scales,
                              None, 64)
    kernel_logits = w8a8_logits("w8a8_kernel")
    if not torch.equal(kernel_logits, w8a8_logits("w8a8")):
        raise RuntimeError("w8a8_kernel logits differ from the plain w8a8 "
                           "plan's")
    acc_w8a8 = accuracy(lambda x: x, kernel_logits, eval_labels)
    sync()
    seconds["exact_w8a8"] = time.perf_counter() - t1

    # One fabricated chip per layer (Fig. 9 nominal non-idealities) at
    # PRNGKey(100 + i).
    t2 = time.perf_counter()
    d = deploy(params, cfg, "cim", calib_imgs, 0, dev, a_scales=a_scales)
    acc = {}
    for name in ("raw", "finetuned"):
        acc[name] = accuracy(
            lambda x: vgg.vgg8_forward(d[name], x, cfg, mode="cim",
                                       a_scales=a_scales, chips=d["chips"]),
            eval_imgs, eval_labels, bs=32)
    sync()
    seconds["cim"] = time.perf_counter() - t2

    acc_raw, acc_ft = acc["raw"], acc["finetuned"]
    rows = [emit("fig10_acc_exact", 0.0, f"{acc_exact:.3f}"),
            emit("fig10_acc_w8a8", 0.0, f"{acc_w8a8:.3f}"),
            emit("fig10_acc_cim_raw", 0.0, f"{acc_raw:.3f}"),
            emit("fig10_acc_cim_finetuned", 0.0,
                 f"{acc_ft:.3f} recovery=+{acc_ft-acc_raw:.3f} "
                 f"(paper: 86.5%->88.6%)")]
    claims = {"exact_above_0.6": acc_exact > 0.6,
              "finetune_not_worse": acc_ft >= acc_raw - 0.01}
    result = {"device": str(dev), "steps": steps, "batch": batch,
              "n_eval": n_eval, "n_calib": n_calib,
              "image_size": cfg.image_size,
              "acc": {"exact": acc_exact, "w8a8": acc_w8a8,
                      "cim_raw": acc_raw, "cim_finetuned": acc_ft},
              "claims": claims, "loss_first": losses[0] if losses else None,
              "loss_last": losses[-1] if losses else None,
              "seconds": seconds, "rows": rows}
    if check_claims:
        assert claims["exact_above_0.6"], f"training failed: {acc_exact}"
        assert claims["finetune_not_worse"], "fine-tune must not hurt"
    return result


def run(plan, *, device="cuda", n_eval: int = 64, seed: int = 0,
        cfg: vgg.Vgg8Config | None = None, n_calib: int = 64) -> dict:
    """The whole deploy flow; returns the printed result.  ``cfg`` and
    ``n_calib`` let tests run it at a reduced size."""
    dev = device_lib.resolve(device)
    plan = backend_lib.as_plan(plan)
    cfg = cfg or vgg8_cifar10.config()

    def key(offset):
        return prng.PRNGKey(seed + offset, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    params = vgg.init_vgg8(key(0), cfg)
    eval_imgs, eval_labels = synthetic.synthetic_cifar(
        key(99), n_eval, cfg.n_classes, cfg.image_size)
    calib_imgs, _ = synthetic.synthetic_cifar(
        key(7), n_calib, cfg.n_classes, cfg.image_size)
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
    ap.add_argument("--eval", type=int, default=None,
                    help="eval images (default 64; 192 with --train-steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="train this many steps and run the accuracy "
                    "experiment (0: the random-weight deploy)")
    args = ap.parse_args(argv)
    if args.train_steps > 0:
        return accuracy_run(device=args.device, steps=args.train_steps,
                            n_eval=args.eval or 192)
    result = run(backend_lib.load_plan(args.plan), device=args.device,
                 n_eval=args.eval or 64, seed=args.seed)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
