"""Training launcher of the PyTorch port: ``repro/launch/train.py`` with
the same flags and defaults, plus ``--device``.

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
file).

``--devices N --mesh-shape d,m`` (or ``p,d,m``) trains on a DeviceMesh
of N ranks, as the JAX launcher's pjit path: params and the optimizer's
master, m and v laid out by ``sharding.resolve_param_specs`` (``step``
replicated), each step's batch by ``sharding.data_specs``
(``train_loop.make_train_step(..., mesh=...)``), checkpoints written as
full arrays by rank 0 and restored onto the mesh that is running.  It
starts the N ranks itself (gloo with ``--device cpu``, one CUDA card per
rank otherwise: fewer cards than N raises) unless a launcher's ``RANK``
/ ``WORLD_SIZE`` are in the environment.
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
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh (one card each on cuda)")
    ap.add_argument("--mesh-shape", default=None,
                    help="d,m or p,d,m (data, model[, pod]) mesh shape")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--plan", default=None,
                    help="training DeploymentPlan (e.g. 'qat', inline JSON, "
                         "or a JSON file) routed through the backend registry")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch import mesh as mesh_lib

    shape = None
    if args.mesh_shape is not None or (args.devices or 1) > 1:
        shape, n_dev = mesh_lib.shape_and_count(args.mesh_shape,
                                                args.devices)
        if not torch.distributed.is_initialized():
            mesh_lib.check_devices(n_dev, args.device)
            if "WORLD_SIZE" not in os.environ:
                return mesh_lib.spawn(_rank_main, n_dev, device=args.device,
                                      args=(argv,))[0]
            mesh_lib.init_group(args.device)

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
    if dev.type == "cuda" and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = not torch.distributed.is_initialized() \
        or torch.distributed.get_rank() == 0
    cfg = cfg_lib.reduced_config(args.arch) if args.reduced \
        else cfg_lib.get_config(args.arch)
    tcfg = TrainConfig(lr=1e-3, total_steps=args.steps, warmup_steps=5,
                       checkpoint_every=max(args.steps // 2, 1), remat=True)

    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    opt = opt_lib.init_opt_state(params)
    mesh = shardings = None
    if shape is not None:
        from repro_torch.distributed import sharding
        mesh = mesh_lib.make_mesh(shape, device=dev.type)
        param_sh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
        shardings = {"params": param_sh,
                     "opt": {"master": param_sh, "m": param_sh,
                             "v": param_sh, "step": None}}
        state = sharding._map(
            lambda x, sh: x if sh is None else sharding.distribute(x, sh),
            {"params": params, "opt": opt}, shardings)
        params, opt = state["params"], state["opt"]
    stream = synthetic.TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = mgr.latest_step() or 0
    if start:
        restored = mgr.restore(start, {"params": params, "opt": opt},
                               shardings, device=dev)
        params, opt = restored["params"], restored["opt"]
        if lead:
            print(f"resumed from step {start}")

    plan = None
    if args.plan is not None:
        plan = backend_lib.load_plan(args.plan)
    step_fn = make_train_step(cfg, tcfg, plan=plan, mesh=mesh)
    history = []
    with deterministic():
        for step in range(start, args.steps):
            batch = synthetic.lm_batch(stream, step, device=dev)
            params, opt, metrics = step_fn(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm})
            if lead:
                print(f"step {step}: loss={loss:.4f} gnorm={gnorm:.2f}")
            if (step + 1) % tcfg.checkpoint_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt})
    mgr.wait()
    if lead:
        where = "" if mesh is None else (
            f" on {torch.distributed.get_world_size()} devices, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        print(f"done{where}")
    return {"start": start, "history": history, "params": params,
            "opt": opt}


def _rank_main(rank, argv):
    """One rank of a spawned mesh run: ``main`` in the running group;
    rank 0 returns the loss history."""
    out = main(argv)
    return {"start": out["start"], "history": out["history"]} \
        if rank == 0 else None


if __name__ == "__main__":
    main()
