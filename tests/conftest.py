"""Shared test fixtures.  NOTE: XLA_FLAGS / host-device-count is deliberately
NOT set here — smoke tests and benchmarks must see the single real CPU
device.  Distributed tests that need multiple devices spawn subprocesses
(see tests/test_distributed.py)."""
import importlib.util
import os
import pathlib

# Keep CPU compiles light and deterministic for the test suite.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    import hypothesis  # noqa: F401
except ImportError:
    _stub_path = pathlib.Path(__file__).parent / "_hypothesis_stub.py"
    _spec = importlib.util.spec_from_file_location("_hypothesis_stub", _stub_path)
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    _mod.install()

import jax
import pytest

jax.config.update("jax_enable_x64", False)

CHIP_SEED = 42  # single RNG root for every sampled chip in the suite


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an sm_90 CUDA card (the port's hand-written "
        "kernels); skipped elsewhere")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def chip_key():
    """The suite-wide chip RNG key.  Derive per-test chips with fold_in so
    macro/caat/executor tests all draw from one seeded root instead of
    ad-hoc PRNGKey(n) constants (kills cross-test RNG drift)."""
    return jax.random.PRNGKey(CHIP_SEED)


@pytest.fixture(autouse=True)
def _serve_allocator_invariants():
    """Every serve test tears down through the allocator's own proof: each
    ContinuousEngine constructed during the test runs with the scheduler
    debug flag forced on (check_invariants at every retire) and has its
    books re-checked after the test body — a block leak anywhere in the
    suite fails loudly at the test that caused it."""
    from repro.serve import server as server_mod

    engines = []
    orig_init = server_mod.ContinuousEngine.__init__

    def tracked_init(self, *args, **kwargs):
        kwargs["debug_invariants"] = True
        orig_init(self, *args, **kwargs)
        engines.append(self)

    server_mod.ContinuousEngine.__init__ = tracked_init
    try:
        yield
    finally:
        server_mod.ContinuousEngine.__init__ = orig_init
        for ce in engines:
            ce.allocator.check_invariants()
            assert ce.allocator.hidden_blocks == 0, \
                "fault-injected hidden blocks leaked past the run"


@pytest.fixture(scope="session")
def chip_factory(chip_key):
    """chip_factory(cfg, salt=0) -> deterministic macro.MacroSample.

    Session-cached: the same (rows, salt) pair always returns the identical
    chip object, so tests that compare against each other's chips see the
    same silicon."""
    from repro.core import macro as macro_lib

    cache: dict = {}

    def make(cfg: "macro_lib.MacroConfig", salt: int = 0):
        key_id = (cfg, salt)
        if key_id not in cache:
            cache[key_id] = macro_lib.sample_chip(
                jax.random.fold_in(chip_key, salt), cfg)
        return cache[key_id]

    return make
