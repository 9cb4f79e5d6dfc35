"""Execution backends and per-layer deployment plans (port of
``repro/core/backend.py``, main-path subset).

Each linear-layer execution strategy is an :class:`ExecutionBackend`
registered under a name; a :class:`DeploymentPlan` maps layer path
patterns (fnmatch) to backends.  Ported backends:

* ``exact``        -- float matmul in the layer's compute dtype;
* ``w8a8``         -- int8 x int8 -> exact int32 + one fused epilogue, as
                      plain PyTorch (the plain twin of ``w8a8_kernel``);
* ``w8a8_kernel``  -- the same semantics through the hand-written CUDA
                      kernel (``kernels/cim_matmul``), with the f32 -> int8
                      input quantization fused into the kernel prologue;
* ``bitserial``    -- the prior-work baseline: one pass per activation
                      bit-plane, digital shift-add, optional per-plane ADC;
* ``bitserial_kernel`` -- the same baseline as 8 launches of the CUDA
                      bit-plane kernel (``kernels/bitserial_matmul``);
* ``cim``          -- the behavioural macro simulation (CAAT mismatch, ADC
                      INL, per-row-tile conversions) with the output-based
                      fine-tune affine;
* ``qat``          -- fake-quant W8A8 training on master params with
                      straight-through gradients; freezes to the ``w8a8``
                      layout.

Plans serialize to the same JSON as the JAX package's, so a plan written
by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Any, Callable

import torch

from repro_torch.core import calibration as cal_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import quant
from repro_torch.distributed import spmd

Params = dict[str, Any]

@dataclasses.dataclass(frozen=True)
class LinearSpec:
    in_dim: int
    out_dim: int
    use_bias: bool = False
    relu: bool = False            # fuse ReLU into the conversion epilogue
    mode: str = "exact"
    dtype: Any = torch.bfloat16   # compute dtype for exact
    # CiM-sim knobs (mode == 'cim'):
    macro: macro_lib.MacroConfig = macro_lib.MacroConfig()
    # Bit-serial baseline knobs (mode == 'bitserial'):
    plane_adc_bits: int | None = None   # per-plane ADC bits (None = exact)
    dynamic_plane_fs: bool = False      # runtime autorange (study only)

    def __post_init__(self):
        if self.mode not in _REGISTRY:
            raise ValueError(
                f"unknown mode {self.mode!r}; expected one of "
                f"{available_backends()}")


_REGISTRY: dict[str, "ExecutionBackend"] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a backend under `name`."""
    def deco(cls: type) -> type:
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_backend(name: "str | ExecutionBackend") -> "ExecutionBackend":
    if isinstance(name, ExecutionBackend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


class ExecutionBackend:
    """One execution strategy for a weight-stationary linear layer.

    Subclasses set ``frozen = True`` when ``apply`` consumes deployed int8
    params ('w_q'); float backends run on master params ('w')."""

    name: str = "?"
    frozen: bool = False
    deploys_int8: bool = False
    needs_chip: bool = False      # does apply() need a sampled chip?
    supports_out_requant: bool = False

    def init(self, gen: torch.Generator, spec: LinearSpec,
             scale: float | None = None) -> Params:
        """Master (float) parameters with fan-in scaled init, on
        ``gen``'s device."""
        if scale is None:
            scale = spec.in_dim ** -0.5
        w = torch.randn((spec.in_dim, spec.out_dim), generator=gen,
                        device=gen.device) * scale
        p: Params = {"w": w.to(spec.dtype)}
        if spec.use_bias:
            p["b"] = torch.zeros(spec.out_dim, dtype=torch.float32,
                                 device=gen.device)
        return p

    def freeze(self, params: Params, spec: LinearSpec | None = None,
               a_scale: float = 1.0, **kw) -> Params:
        """Deploy transform.  Float backends keep master params."""
        return params

    def apply(self, params: Params, x, spec: LinearSpec | None = None, *,
              a_scale=None, chip=None, return_stats: bool = False,
              out_scale=None):
        """Run the linear on a float activation or a QTensor.  With
        ``return_stats`` returns (y, stats): the conversion accounting
        (n_conversions, n_passes, relu_fused, neg_fraction)."""
        raise NotImplementedError

    def _bytes_moved(self, spec: LinearSpec, batch: int) -> float:
        """Approximate device-memory traffic of one apply."""
        k, n = spec.in_dim, spec.out_dim
        return 2.0 * (k * n + batch * k) + 2.0 * batch * n

    def flops_per_byte(self, spec: LinearSpec, batch: int = 1) -> float:
        """Arithmetic intensity of one apply at the given batch."""
        return (2.0 * batch * spec.in_dim * spec.out_dim
                / self._bytes_moved(spec, batch))

    def stats(self, spec: LinearSpec, batch: int = 1) -> dict:
        """Static (shape-derived) conversion accounting for one apply."""
        return {"n_conversions": 0.0, "n_passes": 1.0, "relu_fused": 0.0,
                "neg_fraction": 0.0}

    def _finish(self, y, stats, return_stats):
        return (y, stats) if return_stats else y


def _w8a8_freeze(params: Params, a_scale) -> Params:
    """Master float linear -> deployed int8 form with static scales:
    per-output-channel weight scales, a 0-dim activation scale."""
    w = params["w"].to(torch.float32)
    scale = quant.absmax_scale(w, axis=-2)           # [1, N]
    frozen: Params = {
        "w_q": quant.quantize(w, scale),
        "w_scale": scale.squeeze(-2),
        "a_scale": torch.full((), float(a_scale), dtype=torch.float32,
                              device=w.device),
    }
    if "b" in params:
        frozen["b"] = params["b"].to(torch.float32)
    return frozen


def _batch_elems(x) -> float:
    b = 1.0
    for d in x.shape[:-1]:
        b *= d
    return b


def _quantize_input(params: Params, x, a_scale):
    """x -> (int8 codes, scale).  A QTensor input keeps its own scale (the
    residency contract); a float input is quantized on the frozen
    a_scale."""
    if isinstance(x, quant.QTensor):
        return x.q, x.scale
    a_s = params.get("a_scale", a_scale)
    if a_s is None:
        raise ValueError("frozen backends need a static activation scale")
    return quant.quantize(x.to(torch.float32), a_s), a_s


@register_backend("exact")
class ExactBackend(ExecutionBackend):
    """Float matmul baseline; freeze() is the identity."""

    def apply(self, params, x, spec=None, *, a_scale=None, chip=None,
              return_stats=False, out_scale=None):
        if isinstance(x, quant.QTensor):
            x = x.dequant()
        dtype = spec.dtype if spec is not None else x.dtype
        y = x.to(dtype) @ params["w"].to(dtype)
        if "b" in params:
            y = y + params["b"].to(dtype)
        if spec is not None and spec.relu:
            y = torch.clamp_min(y, 0)
        return self._finish(y, self.stats(spec), return_stats)


@register_backend("qat")
class QatBackend(ExecutionBackend):
    """Fake-quant W8A8 with straight-through gradients (training for the
    macro): a per-tensor activation scale (the absmax of ``x`` unless
    ``a_scale`` is given) and per-output-channel weight scales from the
    master weights.  ``freeze`` deploys to the ``w8a8`` layout."""

    deploys_int8 = True

    def freeze(self, params, spec=None, a_scale=1.0, **kw):
        return _w8a8_freeze(params, a_scale)

    def apply(self, params, x, spec=None, *, a_scale=None, chip=None,
              return_stats=False, out_scale=None):
        if isinstance(x, quant.QTensor):
            x = x.dequant()
        dtype = spec.dtype if spec is not None else x.dtype
        relu = spec.relu if spec is not None else False
        # On a mesh the per-tensor scale is the global batch's.
        a_s = a_scale if a_scale is not None \
            else spmd.batch_max(quant.absmax_scale(x.detach()))
        w = params["w"].to(torch.float32)
        w_s = quant.absmax_scale(w.detach(), axis=0)
        y = quant.qat_linear(x.to(torch.float32), w, a_s, w_s,
                             bias=params.get("b"), relu=relu).to(dtype)
        stats = {"n_conversions": 0.0, "n_passes": 1.0,
                 "relu_fused": 1.0 if relu else 0.0, "neg_fraction": 0.0}
        return self._finish(y, stats, return_stats)


class _SingleConversionBackend(ExecutionBackend):
    """Shared plumbing for the deployed single-conversion int8 paths."""

    frozen = True
    deploys_int8 = True
    supports_out_requant = True
    n_passes = 1.0
    fused_input_quant = False   # quantize float inputs in the kernel prologue

    def freeze(self, params, spec=None, a_scale=1.0, **kw):
        return _w8a8_freeze(params, a_scale)

    def _matmul(self, xq, w_q, a_s, w_scale, bias, relu, out_scale=None):
        raise NotImplementedError

    def apply(self, params, x, spec=None, *, a_scale=None, chip=None,
              return_stats=False, out_scale=None):
        relu = spec.relu if spec is not None else False
        if self.fused_input_quant and not isinstance(x, quant.QTensor):
            a_s = params.get("a_scale", a_scale)
            if a_s is None:
                raise ValueError(
                    "frozen backends need a static activation scale")
            xq = x.to(torch.float32)
        else:
            xq, a_s = _quantize_input(params, x, a_scale)
        y = self._matmul(xq, params["w_q"], a_s, params["w_scale"],
                         params.get("b"), relu, out_scale)
        if out_scale is not None:
            if y.dtype != torch.int8:
                y = quant.quantize(y, out_scale)
            y = quant.QTensor(y, out_scale)
        stats = {"n_conversions": _batch_elems(x) * params["w_q"].shape[-1]
                 * self.n_passes,
                 "n_passes": self.n_passes,
                 "relu_fused": 1.0 if relu else 0.0,
                 "neg_fraction": 0.0}
        return self._finish(y, stats, return_stats)

    def stats(self, spec, batch=1):
        return {"n_conversions": float(batch * spec.out_dim) * self.n_passes,
                "n_passes": self.n_passes,
                "relu_fused": 1.0 if spec.relu else 0.0,
                "neg_fraction": 0.0}

    def _bytes_moved(self, spec, batch):
        k, n = spec.in_dim, spec.out_dim
        # int8 weights + int8 activations, one f32 epilogue write per pass.
        return self.n_passes * (k * n + batch * k) + 4.0 * batch * n


@register_backend("w8a8")
class W8A8Backend(_SingleConversionBackend):
    """int8 matmul + ONE fused dequant/bias/ReLU/requant epilogue, as plain
    PyTorch on any device."""

    def _matmul(self, xq, w_q, a_s, w_scale, bias, relu, out_scale=None):
        return quant.w8a8_matmul(xq, w_q, a_s, w_scale, bias=bias, relu=relu,
                                 out_scale=out_scale)


@register_backend("w8a8_kernel")
class W8A8KernelBackend(_SingleConversionBackend):
    """Same semantics as w8a8 through the CUDA kernel: float inputs are
    quantized in the kernel prologue, int8 outputs come straight from the
    requant epilogue.  On CPU tensors the kernel's plain twin runs."""

    fused_input_quant = True

    def _matmul(self, xq, w_q, a_s, w_scale, bias, relu, out_scale=None):
        from repro_torch.kernels.cim_matmul import ops as kops
        return kops.cim_matmul(xq, w_q, a_s, w_scale, bias=bias,
                               out_scale=out_scale, relu=relu)


@register_backend("bitserial")
class BitserialBackend(_SingleConversionBackend):
    """Prior-work baseline: one pass per activation bit + digital
    shift-add, one conversion per activation bit.  With
    ``spec.plane_adc_bits`` each plane's partial sum is converted against
    a static calibrated full scale (frozen as 'plane_fs'); the runtime
    autorange is an explicit opt-in (``spec.dynamic_plane_fs``)."""

    n_passes = 8.0

    def freeze(self, params, spec=None, a_scale=1.0, *,
               plane_full_scale=None, calib_a_q=None, **kw):
        frozen = _w8a8_freeze(params, a_scale)
        if plane_full_scale is not None:
            frozen["plane_fs"] = torch.as_tensor(
                plane_full_scale, dtype=torch.float32,
                device=frozen["w_q"].device)
        elif calib_a_q is not None:
            frozen["plane_fs"] = quant.calibrate_plane_full_scale(
                calib_a_q, frozen["w_q"])
        return frozen

    def apply(self, params, x, spec=None, *, a_scale=None, chip=None,
              return_stats=False, out_scale=None):
        relu = spec.relu if spec is not None else False
        xq, a_s = _quantize_input(params, x, a_scale)
        y = quant.bitserial_matmul(
            xq, params["w_q"], a_s, params["w_scale"],
            bias=params.get("b"), relu=relu,
            plane_adc_bits=spec.plane_adc_bits if spec is not None else None,
            plane_full_scale=params.get("plane_fs"),
            dynamic_plane_fs=(spec.dynamic_plane_fs if spec is not None
                              else False))
        if out_scale is not None:
            y = quant.QTensor(quant.quantize(y, out_scale), out_scale)
        stats = {"n_conversions": _batch_elems(x) * params["w_q"].shape[-1]
                 * 8.0,
                 "n_passes": 8.0,
                 "relu_fused": 0.0,   # ReLU follows the digital shift-add
                 "neg_fraction": 0.0}
        return self._finish(y, stats, return_stats)


@register_backend("bitserial_kernel")
class BitserialKernelBackend(_SingleConversionBackend):
    """The bit-serial baseline through the CUDA bit-plane kernel: 8
    launches + the shift-add in plain PyTorch (on CPU tensors the kernel's
    plain twin runs)."""

    n_passes = 8.0

    def _matmul(self, xq, w_q, a_s, w_scale, bias, relu, out_scale=None):
        from repro_torch.kernels.bitserial_matmul import ops as kops
        # out_scale is applied by the base apply: the bit-plane kernel's
        # digital shift-add has no requant slot.
        return kops.bitserial_matmul(xq, w_q, a_s, w_scale, bias=bias,
                                     relu=relu)


@register_backend("cim")
class CimBackend(ExecutionBackend):
    """Behavioural macro simulation: CAAT mismatch + ADC INL + per-row-tile
    conversions, with the output-based fine-tune affine.  Needs a chip
    sample and the spec's macro config at freeze/apply time."""

    frozen = True
    deploys_int8 = True
    needs_chip = True
    supports_out_requant = True

    def freeze(self, params, spec=None, a_scale=1.0, *, chip=None,
               finetune=None, v_fs_mac=None, **kw):
        if spec is None:
            raise ValueError("cim freeze needs a LinearSpec (macro config)")
        frozen = _w8a8_freeze(params, a_scale)
        dev = frozen["w_q"].device
        if v_fs_mac is None:
            v_fs_mac = macro_lib.default_v_fs(127.0, 127.0, spec.in_dim,
                                              spec.macro.rows)
        frozen["v_fs_mac"] = torch.as_tensor(v_fs_mac, dtype=torch.float32,
                                             device=dev)
        ft = finetune or cal_lib.identity_finetune(dev)
        frozen["ft_gain"] = torch.as_tensor(ft.gain, dtype=torch.float32,
                                            device=dev)
        frozen["ft_offset"] = torch.as_tensor(ft.offset, dtype=torch.float32,
                                              device=dev)
        if chip is not None:
            frozen["chip"] = chip
        return frozen

    def apply(self, params, x, spec=None, *, a_scale=None, chip=None,
              return_stats=False, out_scale=None):
        if spec is None:
            raise ValueError("cim apply needs a LinearSpec (macro config)")
        the_chip = chip if chip is not None else params.get("chip")
        if the_chip is None:
            raise ValueError("cim mode needs a chip sample")
        xq, a_s = _quantize_input(params, x, a_scale)
        lead = xq.shape[:-1]
        codes, sim = macro_lib.cim_matmul_sim(
            xq.reshape(-1, xq.shape[-1]), params["w_q"], the_chip,
            params["v_fs_mac"], spec.macro, relu=spec.relu)
        adc_lsb = params["v_fs_mac"] / (2.0 ** (spec.macro.adc.n_bits - 1))
        y = codes * adc_lsb * (a_s * params["w_scale"])
        y = y * params["ft_gain"] + params["ft_offset"]
        if spec.use_bias:
            y = y + params["b"]
        # Fine-tune offsets can push a fused-ReLU output below 0: re-clamp.
        if spec.relu:
            y = torch.clamp_min(y, 0.0)
        y = y.reshape(*lead, -1)
        if out_scale is not None:
            y = quant.QTensor(quant.quantize(y, out_scale), out_scale)
        stats = {"n_conversions": sim["n_conversions"], "n_passes": 1.0,
                 "relu_fused": sim["relu_fused"],
                 "neg_fraction": sim["neg_fraction"],
                 "n_tiles": sim["n_tiles"]}
        return self._finish(y, stats, return_stats)

    def stats(self, spec, batch=1):
        n_tiles = -(-spec.in_dim // spec.macro.rows)
        return {"n_conversions": float(batch * spec.out_dim * n_tiles),
                "n_passes": 1.0,
                "relu_fused": 1.0 if (spec.relu and n_tiles == 1) else 0.0,
                "neg_fraction": 0.0,
                "n_tiles": float(n_tiles)}


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """Backend + optional calibration overrides for the layers a pattern
    matches."""
    backend: str
    a_scale: float | None = None
    plane_adc_bits: int | None = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    """Pattern -> backend mapping consumed by models, serving and launch.

    ``rules`` is an ordered tuple of (fnmatch pattern, LayerRule); the
    first match wins, else ``default``.  ``residency=True`` shares one int8
    conversion between the linears reading one activation (attention
    q/k/v, MLP gate/up).  ``paged_attn=True`` routes paged attention
    through the fused kernels (``kernels/paged_attention``) instead of the
    gather-then-attend reference."""
    rules: tuple[tuple[str, LayerRule], ...] = ()
    default: str = "w8a8"
    residency: bool = False
    paged_attn: bool = False

    def __post_init__(self):
        norm = tuple(
            (pat, rule if isinstance(rule, LayerRule) else LayerRule(rule))
            for pat, rule in self.rules)
        object.__setattr__(self, "rules", norm)

    def rule_for(self, path: str) -> LayerRule:
        for pattern, rule in self.rules:
            if fnmatch.fnmatchcase(path, pattern):
                return rule
        return LayerRule(self.default)

    def backend_for(self, path: str) -> str:
        return self.rule_for(path).backend

    def validate(self) -> "DeploymentPlan":
        for _, rule in self.rules:
            get_backend(rule.backend)
        get_backend(self.default)
        return self

    def to_json(self) -> str:
        obj: dict = {
            "default": self.default,
            "rules": [[pat, rule.to_dict()] for pat, rule in self.rules],
        }
        if self.residency:
            obj["residency"] = True
        if self.paged_attn:
            obj["paged_attn"] = True
        return json.dumps(obj)

    @classmethod
    def from_json(cls, text: str) -> "DeploymentPlan":
        obj = json.loads(text)
        rules = tuple(
            (pat, LayerRule(**rd)) for pat, rd in obj.get("rules", ()))
        return cls(rules=rules, default=obj.get("default", "w8a8"),
                   residency=obj.get("residency", False),
                   paged_attn=obj.get("paged_attn", False)).validate()


ModeLike = Any  # str | DeploymentPlan | None


def as_plan(mode: ModeLike, default: str = "exact") -> DeploymentPlan:
    """Normalize a mode-or-plan into a DeploymentPlan."""
    if mode is None:
        mode = default
    if isinstance(mode, DeploymentPlan):
        return mode
    get_backend(mode)
    return DeploymentPlan(rules=(), default=mode)


def load_plan(spec: str) -> DeploymentPlan:
    """Parse a plan from a CLI string: a backend name, inline JSON, or a
    path to a JSON file."""
    spec = spec.strip()
    if spec.startswith("{"):
        return DeploymentPlan.from_json(spec)
    if spec in _REGISTRY:
        return DeploymentPlan(rules=(), default=spec)
    with open(spec) as f:
        return DeploymentPlan.from_json(f.read())


def residency_enabled(mode: ModeLike) -> bool:
    return isinstance(mode, DeploymentPlan) and mode.residency


def paged_attn_enabled(mode: ModeLike) -> bool:
    return isinstance(mode, DeploymentPlan) and mode.paged_attn


def shared_quant(params_seq, x):
    """One int8 conversion shared by several frozen consumers of x.
    Returns a QTensor on the first consumer's grid only when every
    consumer is deployed int8; otherwise x unchanged."""
    ps = list(params_seq)
    if not ps or any(
            not isinstance(p, dict) or "w_q" not in p or "a_scale" not in p
            for p in ps):
        return x
    return quant.quantize_to(x, ps[0]["a_scale"]) \
        if not isinstance(x, quant.QTensor) else x


def resolve_backend(mode: ModeLike, path: str = "",
                    params: Params | None = None) -> str:
    """Backend name for one dense call site, reconciled with the param
    format: deployed params never run a float backend (-> 'w8a8') and
    master params never run a frozen one (-> 'exact')."""
    if isinstance(mode, DeploymentPlan):
        name = mode.backend_for(path)
    elif mode is None:
        name = "exact"
    else:
        name = mode
    if params is not None:
        backend = get_backend(name)
        if "w_q" in params and not backend.frozen:
            name = "w8a8"
        elif "w_q" not in params and backend.frozen:
            name = "exact"
    return name
