"""PyTorch port, the 2D reference app (``2d_multi.rs``, 4,096 particles) on the
stream ``Session`` at the program's own ``default_spec``, on the CPU (the
kernels' plain versions): the cap rule keeps every particle under the mouse,
leaves the 3D reference scene's spec as it was, the tile-fill watermark
reads the fullest tile before the clip, and the 2D frame matches the
benchmark's plain reference (``bench_torch/reference.py``) under the
``dam2d-ref`` configuration's physics."""

import json
from pathlib import Path

import pytest
import torch

from bench_torch import compare, harness, reference
from fluid_tpu_torch import scene, step
from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import stream_transfer as stx
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.state import ParticleState
from fluid_tpu_torch.utils import timing

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _centroid(p: ParticleState) -> list:
    return [float(v) for v in p.pos[:, :2].mean(dim=0)]


@pytest.mark.parametrize("seed", [1, 2])
def test_strict_2d_app_keeps_every_particle_under_the_mouse(seed):
    """The app's first mouse frame, at the fluid's xy centroid on the calm
    block, packs a tile past the old cap of 128 (the re-bin clipped it and
    the strict check raised at frame 0); at ``default_spec`` the strict
    Session holds all 4,096 through it and two more mouse frames."""
    cfg, p, dom = scene.reference_scene_2d(seed, device="cpu")
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    assert sess.strict and sess.spec == stx.default_spec(cfg, dom, p.n)
    xy = _centroid(p)
    for _ in range(3):
        sess.frame(step.mouse(xy))
    assert sess.live_count() == 4096 and sess.shell_drop() == 0
    assert 128 < sess.fill_peak() <= sess.spec.cap


def test_default_spec_of_the_reference_scenes():
    """The 3D reference scene keeps the spec it had (T=4, cap 128, halo 2,
    A=2,048); the 2D one, with a quarter of the cells a tile at four times
    the density, gets more headroom: the same tiles and budget, a larger
    cap in whole warps."""
    cfg, p, dom = scene.reference_scene_3d(0, device="cpu")
    assert stx.default_spec(cfg, dom, p.n) == stx.StreamSpec(tile=4, cap=128, halo=2,
                                                              active=2048)
    cfg, p, dom = scene.reference_scene_2d(0, device="cpu")
    spec = stx.default_spec(cfg, dom, p.n)
    assert (spec.tile, spec.halo, spec.A) == (4, 2, 1600)
    assert spec.cap > 128 and spec.cap % 32 == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_fill_peak_is_the_fullest_tile_before_the_clip(dim):
    """At a binning, ``fill_peak`` is the largest per-tile count of the
    particles' tile keys, before the clip: above cap where a tile
    overflows (the slots then hold cap)."""
    cfg = default_2d() if dim == 2 else default_3d()
    dom = make_domain(cfg)
    gen = torch.Generator().manual_seed(dim)
    crowd = 60  # particles packed into the cells of the tile at [20, 24)^dim
    pos = torch.cat([scene.uniform_box(gen, 300, (16.0,) * dim, (32.0,) * dim, "cpu"),
                     scene.uniform_box(gen, crowd, (20.2,) * dim, (23.8,) * dim, "cpu")])
    p = ParticleState.create(pos, device="cpu")
    for cap in (32, 128):
        spec = stx.StreamSpec(tile=4, cap=cap, halo=2, active=2048)
        tshape, nt = stx._tile_geometry(dom, spec)
        keys = stx._keys_from_pos(p.pos, dom, spec, tshape, vel=p.vel, dt=cfg.dt)
        want = int(torch.bincount(keys, minlength=nt).max())
        st = stx.bin_particles(p, dom, spec, dt=cfg.dt)
        assert int(st.fill_peak[0]) == want >= crowd
        assert int(st.count.max()) == min(want, cap)
    assert want > 32  # the cap-32 binning overflowed and fill_peak read past it


def test_fill_peak_past_cap_when_not_strict_and_through_restore():
    """A non-strict Session at the old cap of 128 loses particles at the
    centroid mouse frame: its watermark reads above cap where the strict
    check would have raised; ``restore`` carries it as it carries
    ``need_peak``."""
    cfg, p, dom = scene.reference_scene_2d(1, device="cpu")
    old = stx.StreamSpec(tile=4, cap=128, halo=2, active=1600)
    sess = Session(cfg, dom, p, backend="stream", spec=old, strict=False, device="cpu")
    calm = sess.snapshot()
    before = sess.fill_peak()
    assert 0 < before <= 128
    sess.frame(step.mouse(_centroid(p)))
    after = sess.fill_peak()
    assert after > 128 and sess.live_count() < p.n
    pushed = sess.snapshot()
    sess.restore(calm)
    assert sess.fill_peak() == before
    sess.restore(pushed)
    assert sess.fill_peak() == after


def test_strict_check_records_the_fill_peak_with_its_cap():
    """The strict check's one read also gives the recorder a ``fill_peak``
    sample beside the cap, equal to ``Session.fill_peak()``."""
    cfg, p, dom = scene.reference_scene_2d(0, n=256, device="cpu")
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    t0 = timing.time.perf_counter_ns()
    sess.frame()
    sess.run(2)
    got = [c for c in timing.recorder().records(t0, None).counts if c[0] == "fill_peak"]
    assert [(v, lim) for _, _, v, lim in got] == [(sess.fill_peak(), sess.spec.cap)] * 2
    assert got[0][1] < got[1][1]


# How far the port's 2D frame may lie from the reference's on the CPU: both
# run float32 and differ only in the order of their sums (per-tile windows
# and halos against one dense index_add_).  Over seeds 3-5 the port read at
# most 2.7e-5 (pos, in cells, with the mouse) and 1e-5 (vel, C, rho,
# relative); the reference with TF32 contractions reads 3.3e-4 and above
# on each number.  The limits keep a factor of three or more from both.
GAPS = {"pos_gap": 1e-4, "vel_gap": 5e-5, "C_gap": 5e-5, "rho_gap": 5e-5}


@pytest.mark.parametrize("mouse", [False, True], ids=["no-mouse", "mouse"])
def test_2d_frame_matches_the_benchmark_reference(mouse):
    """One frame of a cut 2D scene (1,024 particles, the reference's density,
    in [16,32]^2 of the box) on the stream Session, under the ``dam2d-ref``
    physics read from its configuration file, against ``reference.frame``
    from the same particles, with the mouse at the block's centroid and
    without."""
    conf = json.loads((REPO / "bench_torch" / "configs" / "dam2d-ref.json").read_text())
    phys = conf["physics"]
    cfg = default_2d()
    harness.check_physics(cfg, phys)
    p, dom = scene.dam_break(torch.Generator().manual_seed(3), cfg, 1024,
                             box=((16.0, 16.0), (32.0, 32.0)), device="cpu")
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    start = sess.particles()
    xy = _centroid(start) if mouse else None
    sess.frame(step.mouse(xy) if mouse else step.no_mouse())
    got = sess.particles()
    want = reference.frame({k: getattr(start, k) for k in ("pos", "vel", "C", "mass")}, phys,
                           mouse=xy)
    found = compare.numbers({k: getattr(got, k) for k in ("pos", "vel", "C", "density",
                                                          "pressure")}, want, phys)
    assert found["nonfinite"] == 0
    for k, lim in GAPS.items():
        assert found[k] <= lim, (k, found[k])
    control = compare.numbers(reference.frame({k: getattr(start, k) for k in
                                               ("pos", "vel", "C", "mass")}, phys, mouse=xy,
                                              contract=reference.tf32), want, phys)
    assert all(control[k] > lim for k, lim in GAPS.items())  # the limits tell TF32 apart
    if mouse:  # the impulse moved the block: the comparison saw it
        calm = reference.frame({k: getattr(start, k) for k in ("pos", "vel", "C", "mass")}, phys)
        assert float((calm["pos"] - want["pos"]).abs().max()) > 100 * GAPS["pos_gap"]


def _numbers(got: ParticleState, want: dict, phys: dict) -> dict:
    return compare.numbers({k: getattr(got, k) for k in ("pos", "vel", "C", "density",
                                                         "pressure")}, want, phys)


def test_2d_cell_mouse_limits_hold_a_frame_where_the_float32_hit_test_flips():
    """The mouse's impulse is a step at its radius: a particle whose distance
    lies within rounding of it is pushed in one float32 evaluation and not
    in another.  On seed 276216773 the float32 reference's hit test flips
    for one particle (9.9999988 cells from the mouse, substep 16) where the
    port's agrees with float64 arithmetic; the flipped unit of velocity
    spreads to its neighbours' cells, so the port reads millicells against
    the float32 reference and a few 1e-5 against float64.  On the CPU 7 of
    400 seeds flip one way or the other (the card's reference sums in a
    varying order, so there a seed flips in one run and not the next); the
    cell's mouse limits sit above such a flip and below a wrong impulse
    (the next test)."""
    conf = json.loads((REPO / "bench_torch" / "configs" / "dam2d-ref.json").read_text())
    phys = conf["physics"]
    limits = json.loads((REPO / "bench_torch" / "limits"
                         / "dam2d-ref.interactive.json").read_text())
    cfg, dom, (p,) = harness.build_scenes(conf, 276216773, 1, torch.device("cpu"))
    start = {k: getattr(p, k).clone() for k in ("pos", "vel", "C", "mass")}
    xy = _centroid(p)
    sess = harness.make_session(conf, cfg, dom, p, torch.device("cpu"))
    sess.frame(step.mouse(xy))
    got = sess.particles()
    want = reference.frame(start, phys, mouse=xy)
    exact = reference.frame({k: v.double() for k, v in start.items()}, phys, mouse=xy)
    exact = {k: v.float() for k, v in exact.items()}
    flipped, held = _numbers(got, want, phys), _numbers(got, exact, phys)
    assert flipped["pos_p99"] > 1e-3 and held["pos_p99"] < 1e-4  # the flip is the reference's
    for k in ("nonfinite", "pos_gap", "pos_p99", "vel_p99", "C_p99", "rho_p99"):
        assert flipped[k] <= limits["mouse_" + k], (k, flipped[k])


@pytest.mark.parametrize("change", [{}, dict(sign=-1.0), dict(scale=1.5), dict(radius=0.7)],
                         ids=["unchanged", "sign", "scale", "radius"])
def test_2d_cell_mouse_check_sees_a_wrong_impulse(monkeypatch, change):
    """The 2D app cell, cut to 1,000 particles and one call on the CPU, is
    correct with the stream path's particle tail as it is, and its mouse
    check frame fails a ``mouse_`` limit when the impulse's sign, size or
    radius is wrong."""
    from bench_torch import test_harness
    from fluid_tpu_torch.ops import stream_kernels

    monkeypatch.setattr(harness, "cell_files", test_harness.small_files(1000))
    monkeypatch.setattr(stream_kernels, "_particle_tail", test_harness._tail(**change))
    result, lines, _ = harness.run_cell(test_harness.BENCH,
                                        test_harness.cell("dam2d-ref.interactive"), 13, 0.0,
                                        False, torch.device("cpu"), 0.0)
    assert result["correct"] is (not change), lines
    if change:
        assert any(k.startswith("mouse_") and v["value"] > v["limit"]
                   for k, v in result["checks"].items()), lines
