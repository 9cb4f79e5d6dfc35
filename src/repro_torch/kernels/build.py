"""Build and load the CUDA kernels: ``nvcc`` into one shared library per
source with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into
``<build dir>/<name>-<content hash>.so`` at first use, so an edited source
is rebuilt and an unchanged one is reused.  The build directory defaults
to ``build/kernels`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it).  ``--use_fast_math`` is deliberately absent: the kernels
rely on IEEE division and round-half-to-even conversions.

Nothing here runs at import time; ``nvcc`` is only looked up when a kernel
is first launched (or :func:`build_all` is called).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("cim_matmul", "paged_attention", "flash_prefill",
           "bitplane_matmul", "caat_mac")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by source name.
BUILD_LOG: dict[str, str] = {}
# Wall seconds of each source's nvcc, by source name (absent if cached).
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[pathlib.Path, subprocess.Popen | None]:
    out = _target(name)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    proc.t0 = time.perf_counter()  # type: ignore[attr-defined]
    return out, proc


def _finish(name: str, out: pathlib.Path, proc: subprocess.Popen | None):
    if proc is None:
        BUILD_LOG.setdefault(name, "(cached build)")
        return
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - proc.t0  # type: ignore
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.tmp, out)  # type: ignore[attr-defined]


def build_all() -> float:
    """Compile every kernel source, one ``nvcc`` per source, all started
    together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = [(name, *_start(name)) for name in SOURCES]
    # One waiting thread per source, so each build's seconds end when its
    # own nvcc does.
    with concurrent.futures.ThreadPoolExecutor(len(started)) as pool:
        for f in [pool.submit(_finish, *s) for s in started]:
            f.result()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _LIBS.get(name)
    if lib is None:
        out, proc = _start(name)
        _finish(name, out, proc)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
