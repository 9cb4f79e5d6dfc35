"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card and raise without one unless asked for
the CPU, and its kernel wrappers never fall back to a plain version for a
tensor off the CPU."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_imports_without_jax():
    """Every repro_torch module imports in a process where ``import jax``
    (and anything of the JAX package) fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_names_the_jax_package():
    for path in list(PKG.rglob("*.py")) + list(PKG.rglob("*.cu*")):
        text = path.read_text()
        for line in text.splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert not stripped.split()[1].startswith(("jax", "repro.")), \
                    f"{path}: {line}"
        assert "repro." not in text.replace("repro_torch.", ""), path


@pytest.mark.parametrize("entry", ["init", "pages", "engine", "launch",
                                   "fig10", "static_engine"])
def test_entry_points_default_to_cuda(entry):
    """Without device='cpu' an entry point raises on a machine without
    CUDA (on a machine with a card there is nothing to check here)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    from repro_torch import configs
    from repro_torch.launch import serve as launch
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, kv_pool
    cfg = configs.reduced_config("qwen3-8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "init":
            M.init(cfg, torch.Generator().manual_seed(0))
        elif entry == "pages":
            kv_pool.init_pages(cfg, 8, 4)
        elif entry == "fig10":
            from repro_torch.launch import fig10
            fig10.main(["--plan", "w8a8_kernel"])
        elif entry == "engine":
            params = M.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
            ContinuousEngine(params, cfg, chunked_prefill=True)
        elif entry == "static_engine":
            from repro_torch.serve import Engine
            params = M.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
            Engine(params, cfg)
        else:
            launch.main(["--arch", "qwen3-8b", "--continuous",
                         "--chunked-prefill"])


def test_wrappers_never_fall_back_off_cpu():
    """On a non-CPU tensor every kernel wrapper goes to its kernel, which
    launches or raises; no plain fallback."""
    from repro_torch.core import quant
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cim_ops.cim_matmul(torch.empty(2, 8, device=meta),
                           torch.empty(8, 8, dtype=torch.int8, device=meta),
                           torch.tensor(0.1, device=meta),
                           torch.ones(8, device=meta))
    pages = quant.QTensor(torch.empty(4, 4, 2, 32, dtype=torch.int8,
                                      device=meta),
                          torch.empty(4, 4, 2, 1, dtype=torch.bfloat16,
                                      device=meta))
    tables = torch.zeros(2, 3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        paged_ops.paged_attention(torch.empty(2, 1, 4, 32, device=meta),
                                  pages, pages, tables,
                                  torch.zeros(2, dtype=torch.int32,
                                              device=meta))
    lens = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        paged_ops.paged_prefill(torch.empty(2, 4, 4, 32, device=meta),
                                torch.empty(2, 4, 2, 32, device=meta),
                                torch.empty(2, 4, 2, 32, device=meta),
                                pages, pages, tables, lens, lens)
    from repro_torch.core import macro
    from repro_torch.kernels.bitserial_matmul import ops as bs_ops
    from repro_torch.kernels.caat_mac import ops as caat_ops
    a8 = torch.empty(2, 27, dtype=torch.int8, device=meta)
    w8 = torch.empty(27, 10, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bs_ops.bitserial_matmul(a8, w8, torch.tensor(0.1, device=meta),
                                torch.ones(10, device=meta))
    cfg = macro.MacroConfig(rows=32)
    with pytest.raises(ValueError, match="CUDA"):
        caat_ops.cim_macro_matmul(a8, w8, macro.ideal_chip(cfg, meta), 1e4,
                                  cfg)


def test_bf16_crosses_bit_exact():
    import ml_dtypes
    from repro_torch import convert
    a = (np.random.default_rng(0).standard_normal(64)
         .astype(ml_dtypes.bfloat16))
    t = convert.tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and also when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: chip_smoke.py would run for real")
    script = SRC.parent / "chip_smoke.py"
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(script.read_text())
    for path in (script, lone):
        out = subprocess.run([sys.executable, str(path)], capture_output=True,
                             text=True, cwd=path.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_launcher_serves_on_cpu():
    from repro_torch.launch import serve as launch
    from repro_torch.serve import RequestStatus
    res = launch.main(["--arch", "qwen3-8b", "--continuous",
                       "--chunked-prefill", "--paged-attn", "--plan",
                       "w8a8_kernel", "--device", "cpu", "--batch", "3",
                       "--tokens", "4"])
    assert len(res) == 3
    assert all(r.status is RequestStatus.OK and len(r.tokens) == 4
               for r in res.values())
    res = launch.main(["--arch", "qwen3-8b", "--continuous", "--paged-attn",
                       "--plan", "w8a8_kernel", "--device", "cpu",
                       "--batch", "2", "--tokens", "3"])
    assert all(r.status is RequestStatus.OK and len(r.tokens) == 3
               for r in res.values())
    toks = launch.main(["--arch", "qwen3-8b", "--plan", "w8a8_kernel",
                        "--device", "cpu", "--devices", "1", "--batch", "2",
                        "--tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    for flag, value in (("--devices", "2"), ("--mesh-shape", "1,1")):
        with pytest.raises(NotImplementedError, match=flag):
            launch.main(["--arch", "qwen3-8b", "--continuous", "--device",
                         "cpu", flag, value])


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error (it never silently
    falls back); nothing is built at import time."""
    import shutil
    from repro_torch.kernels import build
    if shutil.which("nvcc") or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("cim_matmul")
    assert list(tmp_path.iterdir()) == []
