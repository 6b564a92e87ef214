"""PyTorch port, ``Session`` on the CPU (mirrors tests/test_session.py): the
stream backend (kernels as their plain versions) against the dense backend
and the frozen goldens, ``run(k)``, the binned histogram, the overflow check
and snapshot replay."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from fluid_tpu_torch import render, scene, state, step
from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as stx
from fluid_tpu_torch.session import Session, default_backend

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _case(iterations=2, n=512, seed=0):
    """A 32x32 2D dam break (the compact domain of tests/test_session.py)."""
    cfg = default_2d().replace(
        iterations=iterations, boundary_clip=((0.0, 0.0), (32.0, 32.0)), grid_res=16
    )
    gen = torch.Generator().manual_seed(seed)
    p, _ = scene.dam_break(gen, cfg, n=n, box=((8.0, 8.0), (24.0, 24.0)),
                          device="cpu")
    return cfg, p, make_domain(cfg, halo_cells=4)


def test_default_backend_follows_the_device():
    assert default_backend("cpu") == "dense"
    assert default_backend(torch.device("cuda", 0)) == "stream"
    cfg, p, dom = _case()
    assert Session(cfg, dom, p, device="cpu").backend == "dense"


def test_session_stream_matches_dense_across_frames():
    """Three frames of 2 substeps: stream and dense agree to 1e-4 (the
    tolerance of tests/test_session.py), and nothing is lost."""
    cfg, p, dom = _case()
    a = Session(cfg, dom, p.clone(), backend="stream", device="cpu")
    b = Session(cfg, dom, p.clone(), backend="dense", device="cpu")
    for _ in range(3):
        a.frame()
        b.frame()
    qa, qb = a.particles(), b.particles()
    np.testing.assert_allclose(qa.pos.numpy(), qb.pos.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(qa.vel.numpy(), qb.vel.numpy(), atol=1e-4, rtol=0)
    assert a.live_count() == 512 and a.shell_drop() == 0
    assert 0 < a.need_peak() <= a.spec.A


def test_session_run_equals_frames():
    """run(k) is k calls of frame(): bit-identical, same re-bin count."""
    cfg, p, dom = _case()
    p.vel = torch.randn(p.vel.shape, generator=torch.Generator().manual_seed(1)) * 20.0
    sa = Session(cfg, dom, p.clone(), backend="stream", device="cpu")
    sb = Session(cfg, dom, p.clone(), backend="stream", device="cpu")
    for _ in range(3):
        sa.frame()
    sb.run(3)
    qa, qb = sa.particles(), sb.particles()
    assert torch.equal(qa.pos, qb.pos) and torch.equal(qa.vel, qb.vel)
    assert sa.rebins() == sb.rebins() > 0


def test_session_histogram_matches_unbinned_render():
    cfg, p, dom = _case()
    sess = Session(cfg, dom, p, backend="stream", device="cpu")
    sess.frame()
    hist = sess.histogram(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    ref = render.histogram(sess.particles().pos, render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert torch.equal(hist, ref) and int(hist.sum()) == 512
    lines = sess.render(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert len(lines) == render.DEFAULT_CONSOLE[1]


def test_session_dense_backend_same_api():
    cfg, p, dom = _case()
    sess = Session(cfg, dom, p, backend="dense", device="cpu")
    sess.frame(step.mouse((32.0, 32.0)))
    assert torch.isfinite(sess.particles().pos).all()
    assert len(sess.render(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)) == 40
    assert (sess.live_count(), sess.shell_drop(), sess.rebins()) == (512, 0, 0)


def test_session_rejects_overflowing_spec():
    cfg, p, dom = _case()
    with pytest.raises(ValueError, match="overflow"):
        Session(cfg, dom, p, backend="stream", device="cpu", spec=stx.StreamSpec(active=8))


def test_session_snapshot_restore_replays_bit_identical():
    cfg, p, dom = _case(iterations=3)
    sess = Session(cfg, dom, p, backend="stream", device="cpu", strict=False)
    sess.frame()
    snap = sess.snapshot()
    sess.run(2)
    a = sess.particles().pos.clone()
    sess.restore(snap)
    sess.run(2)
    assert torch.equal(a, sess.particles().pos)
    sess.restore(snap)  # the snapshot survives a second restore
    sess.run(2)
    assert torch.equal(a, sess.particles().pos)


@pytest.mark.parametrize("name", ["golden_2d", "golden_3d"])
def test_stream_session_matches_frozen_golden(name):
    """The stream backend through Session, on the reference domain, against
    the frozen oracle trajectories at 1e-3 (tests/test_golden.py)."""
    z = np.load(REPO / "tests" / "data" / f"{name}.npz")
    base = default_2d() if name.endswith("2d") else default_3d()
    cfg = base.replace(iterations=int(z["substeps"]))
    p = state.from_numpy(z["pos0"], z["vel0"], z["C0"], device="cpu")
    sess = Session(cfg, make_domain(cfg), p, backend="stream", device="cpu")
    sess.frame()
    got = sess.particles()
    for f in ("pos", "vel", "C", "density", "pressure"):
        np.testing.assert_allclose(getattr(got, f).numpy(), z[f], atol=1e-3, rtol=0, err_msg=f)


def test_default_backend_without_an_argument():
    """``default_backend()`` resolves the device as the entry points do:
    the card, so on a host without CUDA it raises; "cpu" still gives
    "dense"."""
    assert default_backend("cpu") == "dense"
    if torch.cuda.is_available():
        assert default_backend() == "stream"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_backend()


@pytest.mark.parametrize("backend", ["stream", "dense"])
def test_session_block_until_ready(backend):
    cfg, p, dom = _case()
    sess = Session(cfg, dom, p, backend=backend, device="cpu")
    sess.frame()
    assert sess.block_until_ready() is None and sess.live_count() == 512


def test_stream_spec_checks_cap_when_built():
    """A cap the kernels cannot launch (not a positive multiple of 32) fails
    when the spec is built, with the kernels' message; any multiple of 32
    builds, past 256 too (the kernels walk the slots in chunks), and the
    plain versions on the CPU take any cap."""
    for cap in (96 + 1, 48, 0):
        with pytest.raises(ValueError, match=f"cap {cap}: the kernels walk a tile's slots in whole warps"):
            stx.StreamSpec(cap=cap)
    for cap in (32, 256, 288, 512, 1024):
        assert stx.StreamSpec(cap=cap).cap == cap
    cfg, p, dom = _case()
    spec = stx.StreamSpec(active=64)
    st = stx.bin_particles(p, dom, spec)
    g = dataclasses.replace(stx.tile_geom(dom, spec), cap=512)
    stream = torch.cat([st.stream, torch.zeros_like(st.stream), torch.zeros_like(st.stream),
                        torch.zeros_like(st.stream)], dim=2)
    wide = sk.deposit_p2g1(st.count, st.tid, stream, g)
    assert torch.equal(wide, sk.deposit_p2g1(st.count, st.tid, st.stream, stx.tile_geom(dom, spec)))


def test_collect_params_stay_on_the_device():
    """The stream collect's parameters are built without reading the mouse
    tensors on the host: on the meta device, which holds no data, a host
    read would raise.  On the CPU the values are the expected row."""
    cfg = default_2d()
    mp, ma = step.mouse((3.0, 4.0))
    meta = stx.collect_params(cfg, mp.to("meta"), ma.to("meta"), "meta")
    assert meta.device.type == "meta" and meta.shape == (14,)
    got = stx.collect_params(cfg, mp, ma, "cpu")
    want = [cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor,
            cfg.mouse_radius, cfg.boundary_damp_dist, 1.0, 3.0, 4.0, 0.0, 0.0, 64.0, 64.0]
    assert torch.equal(got, torch.tensor(want, dtype=torch.float32))


def test_entry_points_default_to_the_card():
    """Without ``device`` the entry points put their state on the card: on a
    host without CUDA they raise, and with device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults resolve to it")
    pos = np.full((8, 3), 20.0, np.float32)
    cfg = default_3d()
    for call in (lambda: scene.reference_scene_3d(n=64),
                 lambda: scene.reference_scene_2d(n=64),
                 lambda: scene.dam_break(torch.Generator().manual_seed(0), cfg, n=64),
                 lambda: scene.scaled_dam_break(torch.Generator().manual_seed(0), 64),
                 lambda: scene.uniform_box(torch.Generator(), 4, (0.0, 0.0), (1.0, 1.0)),
                 lambda: state.ParticleState.create(pos),
                 lambda: state.from_numpy(pos),
                 lambda: state.GridState.zeros((4, 4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg, p, dom = scene.reference_scene_3d(n=64, device="cpu")
    assert p.device.type == "cpu" and state.GridState.zeros((4, 4), device="cpu").mass.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(cfg, dom, p)
    sess = Session(cfg.replace(iterations=2), dom, p, device="cpu")
    sess.frame()
    assert sess.backend == "dense" and torch.isfinite(sess.particles().pos).all()
