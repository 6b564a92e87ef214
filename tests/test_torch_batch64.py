"""PyTorch port, a batch of scenes packed along x (``scene.pack_scenes``) on
the stream ``Session``'s own path, with no hand-built spec, on the CPU (the
kernels' plain versions): each scene computes in its own coordinates
against its own walls, the last scene's frame is the frame of the same
scene run alone, and the benchmark's ``batch64.impact`` cell runs from its
files at a cut size.  The reference is ``bench_torch/reference.py`` on each
scene alone; a batch of 4 scenes x 512 particles stands in for 64 x 4,096."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_torch import compare, harness, reference
from fluid_tpu_torch import scene, step
from fluid_tpu_torch.config import default_3d
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import stream_transfer as stx
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.state import FIELDS, ParticleState
from fluid_tpu_torch.utils import timing

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "bench_torch" / "configs" / "batch64.json").read_text())
LIMITS = json.loads((REPO / "bench_torch" / "limits" / "batch64.impact.json").read_text())
PHYS = CONF["physics"]
B, N = 4, 512
KEYS = ("pos", "vel", "C", "mass")


def _batch(seed: int):
    """(cfg, packed domain, the batch's rows in scene coordinates)."""
    cfg = default_3d()
    harness.check_physics(cfg, PHYS)
    stack, _ = scene.batched_dam_break(torch.Generator().manual_seed(seed), cfg, B, N,
                                       device="cpu")
    _, dom, stride = scene.pack_scenes(stack, cfg)
    assert (dom.scenes, dom.scene_stride, stride) == (B, 72, 72.0)
    return cfg, dom, scene.batch_rows(stack)


def _scene_rows(p: ParticleState, k: int) -> dict:
    return {f: getattr(p, f)[k * N:(k + 1) * N] for f in FIELDS}


def _numbers(got: dict, want: dict) -> dict:
    return compare.numbers({k: got[k] for k in ("pos", "vel", "C", "density", "pressure")},
                           want, PHYS)


def test_packed_session_runs_each_scene_against_its_own_walls():
    """``Session(cfg, dom, rows)`` with no spec takes the domain's stride;
    the rows go in and come out in scene coordinates, scene after scene,
    and each scene's frame matches ``reference.frame`` of that scene alone
    within the cell's limits of its prefix."""
    cfg, dom, p = _batch(3)
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    assert sess.spec.scene_stride == 72 and sess.spec == stx.default_spec(cfg, dom, B * N)
    start = sess.particles()
    assert torch.equal(start.pos, p.pos)  # in as given, out in scene coordinates
    sess.run(1)
    mid = sess.particles()
    sess.frame()
    got = sess.particles()
    assert bool((got.pos >= 0.0).all() and (got.pos <= 64.0).all())
    for k, prefix in enumerate(("s0_", "sa_", "sb_", "s63_")):
        s0, g = _scene_rows(mid, k), _scene_rows(got, k)
        want = reference.frame({f: s0[f] for f in KEYS}, PHYS)
        found = _numbers(g, want)
        assert float((g["pos"] - s0["pos"]).abs().max()) > 0.1  # the scene moved
        for name, v in found.items():
            if prefix + name in LIMITS:
                assert v <= LIMITS[prefix + name], (k, name, v)


def test_last_scene_equals_the_scene_run_alone():
    """The last scene of the packed batch against the same scene binned
    alone on its own domain (the packed domain's columns of one scene):
    substep by substep bit for bit, every field, up to the first re-bin
    that one of the two makes and the other does not (its tiles hold the
    same particles in the same slot order and compute with the same
    arithmetic, the scene's offset added to integer cells alone).  A re-bin
    that another scene asks for re-keys the last scene too: its predictive
    keys may move a particle into the next tile, and the gather lays a
    tile's slots out tile by tile, so from there the two sum in another
    order.  A frame on they agree to 1e-4 cells (3 seeds read 1.7e-5 at
    most two frames on) and within the cell's ``s63_`` limits."""
    cfg, dom, p = _batch(5)
    spec = stx.default_spec(cfg, dom, p.n)
    alone_dom = make_domain(cfg, halo_cells=4)
    assert alone_dom.origin == dom.origin and alone_dom.shape == (72,) + dom.shape[1:]
    aspec = stx.StreamSpec(tile=4, cap=128, halo=2, active=spec.A)
    last = ParticleState(**{f: v.clone() for f, v in _scene_rows(p, B - 1).items()})
    st = stx.bin_particles(p, dom, spec, dt=cfg.dt)
    sa = stx.bin_particles(last, alone_dom, aspec, dt=cfg.dt)
    mouse = step.no_mouse()

    def fields():
        got = _scene_rows(stx.unbin(st, dom, spec, p.n, 3), B - 1)
        want = stx.unbin(sa, alone_dom, aspec, N, 3)
        return got, {f: getattr(want, f) for f in FIELDS}

    subs = 0
    while int(st.rebins) == int(sa.rebins) == 0:
        stx.frame_inplace(st, cfg, dom, spec, *mouse, substeps=1, n=p.n)
        stx.frame_inplace(sa, cfg, alone_dom, aspec, *mouse, substeps=1, n=N)
        subs += 1
        got, want = fields()
        for f in FIELDS:
            assert torch.equal(got[f], want[f]), (subs, f)
    assert subs >= 20 and int(st.rebins) > int(sa.rebins)  # another scene asked first
    stx.frame_inplace(st, cfg, dom, spec, *mouse, n=p.n)
    stx.frame_inplace(sa, cfg, alone_dom, aspec, *mouse, n=N)
    found = _numbers(*fields())
    assert found["pos_gap"] <= 1e-4, found
    for name, v in found.items():
        if "s63_" + name in LIMITS:
            assert v <= LIMITS["s63_" + name], (name, v)


def test_the_old_packed_arithmetic_fails_the_last_scenes_limits():
    """The frame of a jittered reference dam after 15 frames, computed with
    x moved by the last scene's packed offset (63 x 72, the walls moved
    along, moved back after), as the packed layout computed it before each
    scene kept its own coordinates, fails the cell's ``s63_`` limits
    against the same frame in the dam's own coordinates."""
    cfg = default_3d()
    stack, _ = scene.batched_dam_break(torch.Generator().manual_seed(1), cfg, 1, 4096,
                                       device="cpu")
    s = {"pos": stack.pos[0], "vel": stack.vel[0], "C": stack.C[0], "mass": stack.mass[0]}
    for _ in range(15):
        s = reference.frame({f: s[f] for f in KEYS}, PHYS)
        s["mass"] = stack.mass[0]
    want = reference.frame({f: s[f] for f in KEYS}, PHYS)
    off = 63.0 * 72.0
    moved = dict(PHYS, walls=[[PHYS["walls"][0][0] + off] + PHYS["walls"][0][1:],
                              [PHYS["walls"][1][0] + off] + PHYS["walls"][1][1:]])
    start = {f: s[f].clone() for f in KEYS}
    start["pos"][:, 0] += off
    shifted = reference.frame(start, moved)
    shifted["pos"] = shifted["pos"].clone()
    shifted["pos"][:, 0] -= off
    found = _numbers(shifted, want)
    assert found["pos_p99"] > LIMITS["s63_pos_p99"], found
    own = _numbers(reference.frame({f: s[f] for f in KEYS}, PHYS), want)
    assert own["pos_gap"] == 0.0  # the reference repeats itself on the CPU


def test_a_spec_that_states_another_stride_raises():
    cfg, dom, p = _batch(7)
    spec = stx.default_spec(cfg, dom, p.n)
    for stride in (0.0, 64.0):
        with pytest.raises(ValueError, match="scene_stride"):
            Session(cfg, dom, p, backend="stream",
                    spec=stx.StreamSpec(tile=4, cap=128, halo=2, active=spec.A,
                                        scene_stride=stride), device="cpu")
    with pytest.raises(ValueError, match="stream backend"):
        Session(cfg, dom, p, backend="dense", device="cpu")
    with pytest.raises(ValueError, match="scenes"):
        stx.bin_particles(ParticleState(**{f: getattr(p, f)[:-1] for f in FIELDS}), dom, spec)


def test_strict_check_records_the_need_peak_with_the_budget():
    """The strict check's one read also gives the recorder a ``need_peak``
    sample beside A, which ``active_need_peak.batch`` reads over a stretch."""
    cfg, dom, p = _batch(9)
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    t0 = timing.time.perf_counter_ns()
    sess.frame()
    t1 = timing.time.perf_counter_ns()
    got = [c for c in timing.recorder().records(t0, t1).counts if c[0] == "need_peak"]
    assert [(v, lim) for _, _, v, lim in got] == [(sess.need_peak(), sess.spec.A)]
    run = SimpleNamespace(stretch=SimpleNamespace(_t0=t0 * 1e-9, _t1=t1 * 1e-9))
    share = harness.metric_reader("active_need_peak.batch")(run)
    assert share == pytest.approx(100.0 * sess.need_peak() / sess.spec.A)
    assert 0.0 < share < 100.0


def _small_files(orig):
    """``harness.cell_files`` with the batch cut to 4 scenes of 512
    particles and calls of one frame."""

    def files(bench, c):
        conf, traffic, limits = orig(bench, c)
        conf = json.loads(json.dumps(conf))
        conf["scene"].update(batch=B, particles=N)
        return conf, dict(traffic, frames_per_call=1, trace_frames=1), limits

    return files


def test_the_cell_runs_from_its_files(monkeypatch):
    """``batch64.impact`` through ``harness.run_cell``, cut to 4 x 512 and
    one frame a call on the CPU: correct, with every limit of the cell
    compared, the check frame split into the first, the last and two
    drawn interior scenes."""
    from bench_torch import test_harness

    monkeypatch.setattr(harness, "cell_files", _small_files(harness.cell_files))
    result, lines, run = harness.run_cell(test_harness.BENCH, test_harness.cell("batch64.impact"),
                                          2**31 + 11, 0.0, False, torch.device("cpu"), 0.0)
    assert result["correct"] is True, lines
    assert set(result["checks"]) == set(LIMITS)
    assert run.n == B * N and run.frames >= 1
    assert sorted(run.driver.scenes_checked(run).values())[::3] == [0, B - 1]
    assert "particle_steps_per_s" in result["metrics"]
