"""PyTorch port, the 2D scaled dam (``BASELINE.json`` configs[2], 100,000
particles at rest density in a 182^2 box) on the strict stream ``Session`` at
the program's own ``default_spec``, on the CPU (the kernels' plain
versions): a cut dam of 2,500 particles built the same way runs ``run(k)``
against the benchmark's plain reference (``bench_torch/reference.py``)
under the ``dam2d-100k`` configuration's physics, and the benchmark's
``dam2d-100k.settle`` cell runs from its files at that cut size."""

import json
import math
from pathlib import Path

import pytest
import torch

from bench_torch import compare, harness, reference
from fluid_tpu_torch import scene
from fluid_tpu_torch.ops import stream_transfer as stx
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "bench_torch" / "configs" / "dam2d-100k.json").read_text())
LIMITS = json.loads((REPO / "bench_torch" / "limits" / "dam2d-100k.settle.json").read_text())
N = 2500  # side 25, world ceil(1.15 x 25) = 29: 10^2 tiles of 4^2
KEYS = ("pos", "vel", "C", "mass")

# How far two frames of the port may lie from two of the reference's on the
# CPU: both run float32 and differ only in the order of their sums (per-tile
# windows and halos against one dense index_add_).  Over seeds 1-3, from the
# fresh block and ten frames on, the port read at most 5.7e-6 (pos, in
# cells) and 6.2e-6 (vel, C, rho, relative); the reference with TF32
# contractions reads 5.6e-4 and above on each number.  The limits keep a
# factor of eight or more from both.
GAPS = {"pos_gap": 5e-5, "vel_gap": 5e-5, "C_gap": 5e-5, "rho_gap": 5e-5}


def _walls(n: int) -> list:
    """The walls ``scene.scaled_dam_break`` gives a 2D dam of ``n``."""
    world = math.ceil(1.15 * math.sqrt(n / CONF["physics"]["rest_density"]))
    return [[0.0, 0.0], [float(world)] * 2]


def test_the_configuration_is_the_builders_dam():
    """At the configuration's size the builder gives its walls, and the
    program's ``default_spec`` the layout the configuration states."""
    conf = json.loads(json.dumps(CONF))
    cfg, dom, (p,) = harness.build_scenes(conf, 2**31 + 5, 1, torch.device("cpu"))
    harness.check_physics(cfg, conf["physics"])
    assert _walls(p.n) == conf["physics"]["walls"] and p.n == 100_000
    assert (dom.shape, dom.origin) == ((192, 192), (-4, -4))
    assert stx.default_spec(cfg, dom, p.n) == stx.StreamSpec(tile=4, cap=256, halo=2,
                                                              active=2304)


@pytest.mark.parametrize("seed", [1, 2])
def test_strict_run_matches_the_benchmark_reference(seed):
    """Ten frames into a cut dam, ``Session.run(2)`` on the strict stream
    path against two ``reference.frame`` calls from the same particles,
    under the configuration's physics with the builder's walls; the
    reference with TF32 contractions fails every limit."""
    cfg, p, dom = scene.scaled_dam_break(torch.Generator().manual_seed(seed), N, dim=2,
                                         device="cpu")
    phys = dict(CONF["physics"], walls=_walls(N))
    harness.check_physics(cfg, phys)
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    assert sess.strict and sess.spec == stx.default_spec(cfg, dom, N)
    sess.run(10)
    start = sess.particles()
    sess.run(2)
    got = sess.particles()
    assert sess.live_count() == N and sess.shell_drop() == 0
    assert 0 < sess.fill_peak() <= sess.spec.cap
    want = control = {k: getattr(start, k) for k in KEYS}
    for _ in range(2):
        want = dict(reference.frame(want, phys), mass=start.mass)
        control = dict(reference.frame(control, phys, contract=reference.tf32), mass=start.mass)
    found = compare.numbers({k: getattr(got, k) for k in ("pos", "vel", "C", "density",
                                                          "pressure")}, want, phys)
    assert found["nonfinite"] == 0
    for k, lim in GAPS.items():
        assert found[k] <= lim, (k, found[k])
    tf = compare.numbers(control, want, phys)
    assert all(tf[k] > lim for k, lim in GAPS.items()), tf  # the limits tell TF32 apart
    assert float((got.pos - start.pos).abs().max()) > 100 * GAPS["pos_gap"]  # it moved


def _small_files(orig):
    """``harness.cell_files`` with the dam cut to ``N`` particles (the walls
    the builder gives them), one untimed frame and calls of one frame."""

    def files(bench, c):
        conf, traffic, limits = orig(bench, c)
        conf = json.loads(json.dumps(conf))
        conf["scene"]["particles"] = N
        conf["physics"]["walls"] = _walls(N)
        return conf, dict(traffic, setup_frames=1, frames_per_call=1, trace_frames=1), limits

    return files


def test_the_cell_runs_from_its_files(monkeypatch):
    """``dam2d-100k.settle`` through ``harness.run_cell``, cut to 2,500
    particles and one frame a call on the CPU: correct, with every limit of
    the cell compared."""
    from bench_torch import test_harness

    monkeypatch.setattr(harness, "cell_files", _small_files(harness.cell_files))
    result, lines, run = harness.run_cell(test_harness.BENCH,
                                          test_harness.cell("dam2d-100k.settle"), 2**31 + 23,
                                          0.0, False, torch.device("cpu"), 0.0)
    assert result["correct"] is True, lines
    assert set(result["checks"]) == set(LIMITS)
    assert run.n == N and run.dim == 2 and run.frames >= 1
    assert set(result["metrics"]) == {"setup_s", "particle_steps_per_s"}
