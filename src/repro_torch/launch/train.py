"""Training launcher of the PyTorch port: ``repro/launch/train.py`` with
the same flags and defaults, on one device, plus ``--device``.

Usage:
  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --steps 20 [--plan qat] [--device cpu]

It trains the arch's reduced config (``--reduced`` is on by default and
cannot be turned off, as in the JAX launcher) from seed-0 weights on
``--batch`` x ``--seq`` token batches of ``data.synthetic.lm_batch``:
AdamW at lr 1e-3 with 5 warmup steps, every block rematerialized, a
checkpoint every ``steps // 2`` steps in ``--ckpt-dir`` (two kept), and
a restart resumes from the latest one; the steps run under
``train_loop.deterministic`` (on the card, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set).  ``--plan`` takes a
DeploymentPlan (a backend name such as ``qat``, inline JSON or a JSON
file).  More than one device and ``--mesh-shape`` are not ported yet and
raise ``NotImplementedError``.
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the CPU)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--plan", default=None,
                    help="training DeploymentPlan (e.g. 'qat', inline JSON, "
                         "or a JSON file) routed through the backend registry")
    args = ap.parse_args(argv)

    later = "is not ported yet (ROADMAP queue 1)"
    if args.devices not in (None, 1):
        raise NotImplementedError(f"--devices {args.devices}: more than one "
                                  f"device {later}")
    if args.mesh_shape is not None:
        raise NotImplementedError(f"--mesh-shape {later}")

    import torch

    from repro_torch import configs as cfg_lib
    from repro_torch import device as device_lib
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import backend as backend_lib
    from repro_torch.data import synthetic
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_loop import deterministic, make_train_step

    dev = device_lib.resolve(args.device)
    cfg = cfg_lib.reduced_config(args.arch) if args.reduced \
        else cfg_lib.get_config(args.arch)
    tcfg = TrainConfig(lr=1e-3, total_steps=args.steps, warmup_steps=5,
                       checkpoint_every=max(args.steps // 2, 1), remat=True)

    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    opt = opt_lib.init_opt_state(params)
    stream = synthetic.TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = mgr.latest_step() or 0
    if start:
        restored = mgr.restore(start, {"params": params, "opt": opt},
                               device=dev)
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    plan = None
    if args.plan is not None:
        plan = backend_lib.load_plan(args.plan)
    step_fn = make_train_step(cfg, tcfg, plan=plan)
    history = []
    with deterministic():
        for step in range(start, args.steps):
            batch = synthetic.lm_batch(stream, step, device=dev)
            params, opt, metrics = step_fn(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm})
            print(f"step {step}: loss={loss:.4f} gnorm={gnorm:.2f}")
            if (step + 1) % tcfg.checkpoint_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt})
    mgr.wait()
    print("done")
    return {"start": start, "history": history, "params": params,
            "opt": opt}


if __name__ == "__main__":
    main()
