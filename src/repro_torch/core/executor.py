"""LinearExecutor: spec-based front end over the backend registry (port
of ``repro/core/executor.py``).

Every weight-stationary linear routes through an
:class:`~repro_torch.core.backend.ExecutionBackend` named by
``spec.mode``; this module holds no dispatch logic of its own.  Weights
are stored in float (master) form; ``freeze`` converts a layer to its
deployed int8 form with static scales.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import (  # noqa: F401  (public API)
    DeploymentPlan, LayerRule, LinearSpec, Params, available_backends,
    get_backend, register_backend)

MODES = available_backends()


def init(gen: torch.Generator, spec: LinearSpec,
         scale: float | None = None) -> Params:
    """Master (float) parameters with fan-in scaled init."""
    return get_backend(spec.mode).init(gen, spec, scale)


def freeze(params: Params, spec: LinearSpec, a_scale, chip=None,
           finetune=None, v_fs_mac=None, **kw) -> Params:
    """Convert master params into the deployed int8 form with static
    scales."""
    return get_backend(spec.mode).freeze(
        params, spec, a_scale, chip=chip, finetune=finetune,
        v_fs_mac=v_fs_mac, **kw)


def apply(params: Params, x, spec: LinearSpec, a_scale=None, chip=None,
          return_stats: bool = False, out_scale=None):
    """Run the linear in the spec's backend on a float activation or a
    QTensor.  ``return_stats=True`` returns (y, stats); ``out_scale``
    requantizes to int8 on that grid and returns a QTensor."""
    return get_backend(spec.mode).apply(
        params, x, spec, a_scale=a_scale, chip=chip,
        return_stats=return_stats, out_scale=out_scale)
