"""The JAX scripts of ``bench/`` for the port's micro-benchmark tests:
loaded by path (nothing in ``bench/`` is edited), their Pallas calls in
interpret mode on the CPU."""

import functools
import importlib.util
import sys
from pathlib import Path

from jax.experimental import pallas as pl

BENCH = Path(__file__).resolve().parents[1] / "bench"


def interpret_pallas(monkeypatch) -> None:
    """``pl.pallas_call`` in interpret mode, and ``bench/`` on sys.path for
    micro_pb's ``from micro_sep import ...``, for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.syspath_prepend(str(BENCH))


def load(name: str):
    """``bench/<name>.py`` as a module, loaded once per process."""
    key = f"_bench_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, BENCH / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]
