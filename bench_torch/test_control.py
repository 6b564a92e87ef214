"""The control at a size a test run holds: the reference scene's cells on the
CPU, at their own 4,096 particles.

The program's check numbers stay within each cell's limits, and the
reference in TF32 contractions put in its place (``control.readings``'s
control) exceeds at least one.  Run from the root of the repository::

    python -m pytest bench_torch/test_control.py -q

On the card, ``control.py`` reads the same at each cell's own size over
many seeds; those readings set the limits (PERF.md).  The repository's own
test suite does not collect this file.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", ["dam3d-ref.headless", "dam3d-ref.interactive"])
def test_control_fails_where_the_program_passes(name):
    cell = next(c for c in BENCH["workloads"] if c["name"] == name)
    conf, traffic, limits = harness.cell_files(BENCH, cell)
    if traffic["driver"] == "batch":
        traffic = dict(traffic, frames_per_call=1)
    run = harness.Run(conf, traffic, 2**31 + 5, torch.device("cpu"))
    run.setup()
    run.window(0.0, False, time.perf_counter())
    checks = run.check(limits, control=True)
    assert checks and all(v <= lim for v, lim in checks.values()), checks
    held = [k for k in limits if k in run.control]
    assert any(run.control[k] > limits[k] for k in held), (run.control, limits)
