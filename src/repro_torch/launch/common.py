"""What the paper-figure entry points share: JAX's row format and their
command line.

Every figure they print is the 65nm macro's model (``core/energy.py``,
``core/caat.py``, ``core/adc.py``, ``core/macro.py``), not a measurement
of the machine that runs them."""
from __future__ import annotations

import argparse

from repro_torch.device import resolve  # noqa: F401  (the entry points')


def emit(name: str, us_per_call: float, derived: str = "") -> str:
    """Print one ``name,us,derived`` row, as the JAX package's benchmarks
    print theirs, and return it."""
    row = f"{name},{us_per_call:.2f},{derived}"
    print(row, flush=True)
    return row


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch versions)")
    return ap
