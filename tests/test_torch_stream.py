"""PyTorch port, the stream backend's glue against ``fluid_tpu``: binning is
bit-identical, the substep and a re-binning frame match the JAX dense
backend, and the conservation / budget watermarks fire like the JAX ones.
The kernels run as their plain versions (CPU tensors)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.ops import stream_transfer as jstx
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.ops import stream_transfer as tstx

torch.set_num_threads(1)

STATE_KEYS = ("stream", "count", "tid", "flag", "nbr", "shell_drop", "need_peak", "rebins")


def _case(dim, n, seed, vel_scale=0.4, world=16.0):
    """tests/test_stream.py::_small_case, seeded with numpy."""
    rng = np.random.default_rng(seed)
    base = default_2d() if dim == 2 else default_3d()
    cfg = base.replace(boundary_clip=((0.0,) * dim, (world,) * dim), grid_res=16)
    pos = rng.uniform(world / 4, world - world / 3, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * vel_scale).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    return cfg, pos, vel, C, make_domain(cfg, halo_cells=4)


def _specs(dom, active=None, group=2):
    nt = math.prod(s // 4 for s in dom.shape)
    js = jstx.StreamSpec(tile=4, cap=128, halo=2, group=group,
                         active=min(active or nt, nt), interpret=True)
    return js, tstx.StreamSpec(active=js.A)


def _jax_dense(cfg, dom, pos, vel, C, substeps, mouse=None):
    mp, ma = jstep.no_mouse() if mouse is None else jstep.mouse(mouse)

    @jax.jit
    def run(q):
        return jax.lax.fori_loop(
            0, substeps, lambda _, q: jstep.substep(q, cfg, dom, mp, ma)[0], q
        )

    return run(JParticles.create(pos, vel=vel, C=C))


@pytest.mark.parametrize("dim,dt", [(2, 0.0), (2, None), (3, 0.0), (3, None)],
                         ids=["2d", "2d-predictive", "3d", "3d-predictive"])
def test_bin_particles_equals_jax(dim, dt):
    """count, tid, nbr, the stream rows, the flag and the watermarks are
    exactly JAX's (stable sorts, same occupied-first order), and so is the
    t=0 overflow count, under a budget that fits and one that does not."""
    cfg, pos, vel, C, dom = _case(dim, 256, seed=3, vel_scale=2.0)
    dt = cfg.dt if dt is None else dt
    for active in (None, 2):
        js, ts = _specs(dom, active=active)
        jst = jstx.bin_particles(JParticles.create(pos, vel=vel, C=C), dom, js, dt=dt)
        tst = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, ts, dt=dt)
        want = tstx.stream_state_from_numpy(
            {k: np.asarray(getattr(jst, k)) for k in STATE_KEYS}, ts)
        for k in STATE_KEYS:
            assert torch.equal(getattr(tst, k), getattr(want, k)), k
        assert int(tstx.overflow_count(torch.as_tensor(pos), dom, ts, torch.as_tensor(vel), dt)) == int(
            jstx.overflow_count(jnp.asarray(pos), dom, js, jnp.asarray(vel), dt))
    assert int(tst.shell_drop[0]) > 0  # the tight budget really overflowed


@pytest.mark.parametrize("tshape", [(7, 5), (5, 4, 6)])
def test_active_set_equals_jax(tshape):
    """The needed-relay closure of random occupancy maps equals JAX's."""
    rng = np.random.default_rng(0)
    nt = math.prod(tshape)
    for density in (0.03, 0.15, 0.5):
        occ = rng.random(nt) < density
        want = np.asarray(jstx._active_set(jnp.asarray(occ), tshape))
        got = tstx._active_set(torch.as_tensor(occ), tshape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [2, 3])
def test_unbin_restores_particles_exactly(dim):
    cfg, pos, vel, C, dom = _case(dim, 256, seed=4)
    _, ts = _specs(dom)
    p = tstate.from_numpy(pos, vel, C, density=np.arange(256.0), pressure=-np.arange(256.0),
                          device="cpu")
    q = tstx.unbin(tstx.bin_particles(p, dom, ts, dt=cfg.dt), dom, ts, 256, dim)
    for f in ("pos", "vel", "C", "mass", "density", "pressure"):
        assert torch.equal(getattr(q, f), getattr(p, f)), f


@pytest.mark.parametrize("dim", [2, 3])
def test_stream_substep_matches_jax_dense(dim):
    """One substep on the stream backend (the fused frame path, and the
    bin-substep-unbin ``substep`` with its dense grid) vs JAX dense: 1e-5 on
    the particles, 1e-4 on the grid and density (tests/test_stream.py)."""
    cfg, pos, vel, C, dom = _case(dim, 256, seed=0)
    _, ts = _specs(dom)
    mp, ma = jstep.no_mouse()
    a, ga = jax.jit(lambda q: jstep.substep(q, cfg, dom, mp, ma))(
        JParticles.create(pos, vel=vel, C=C))
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    b = tstx.frame(p, cfg, dom, *tstep.no_mouse(), spec=ts, substeps=1)
    c, gc = tstep.substep(p, cfg, dom, *tstep.no_mouse(), backend="stream")
    for got in (b, c):
        for f in ("pos", "vel", "C"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(a, f)),
                                       atol=1e-5, rtol=0, err_msg=f)
        np.testing.assert_allclose(got.density.numpy(), np.asarray(a.density), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gc.mass.numpy(), np.asarray(ga.mass), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gc.vel.numpy(), np.asarray(ga.vel), atol=1e-4, rtol=0)


def test_stream_mouse_substep_matches_jax_dense():
    cfg, pos, vel, C, dom = _case(2, 192, seed=3)
    _, ts = _specs(dom)
    a = _jax_dense(cfg, dom, pos, vel, C, 1, mouse=(8.0, 8.0))
    b = tstx.frame(tstate.from_numpy(pos, vel, C, device="cpu"), cfg, dom, *tstep.mouse((8.0, 8.0)),
                   spec=ts, substeps=1)
    np.testing.assert_allclose(b.vel.numpy(), np.asarray(a.vel), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), atol=1e-5, rtol=0)


def test_frame_with_rebins_matches_jax():
    """Fast particles force drift re-binning within an 8-substep frame.  The
    port's frame matches JAX dense at 1e-3 and fires exactly as many re-bins
    as JAX's ``frame_binned`` (interpret mode) on the same state."""
    cfg, pos, vel, C, dom = _case(3, 192, seed=1, vel_scale=4.0, world=12.0)
    js, ts = _specs(dom)
    substeps = 8
    want = _jax_dense(cfg, dom, pos, vel, C, substeps)
    mp, ma = jstep.no_mouse()
    jst = jstx.bin_particles(JParticles.create(pos, vel=vel, C=C), dom, js, dt=cfg.dt)
    jst = jax.jit(lambda s: jstx.frame_binned(s, cfg, dom, js, mp, ma, substeps, n=192))(jst)

    tst = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, ts, dt=cfg.dt)
    tst = tstx.frame_binned(tst, cfg, dom, ts, *tstep.no_mouse(), substeps, n=192)
    got = tstx.unbin(tst, dom, ts, 192, 3)
    assert int(tst.rebins[0]) == int(jst.rebins[0]) > 0
    assert int(tst.count.sum()) == 192
    for f in ("pos", "vel", "C"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-3, rtol=0, err_msg=f)


def test_rebin_overflow_detected_by_count_sum():
    """Squeezing every particle into one tile at a re-bin drops all but cap
    of them, and the loss shows in sum(count)."""
    cfg, pos, vel, C, dom = _case(3, 512, seed=9, vel_scale=0.0, world=24.0)
    _, ts = _specs(dom)
    st = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, ts)
    assert int(st.count.sum()) == 512
    st.stream[:, 0:3, :] = 10.0
    tshape, nt = tstx._tile_geometry(dom, ts)
    st2 = tstx._rebin_full(st, cfg.replace(dt=0.0), dom, ts, tshape, nt, 512)
    assert int(st2.count.sum()) == ts.cap, "cap squeeze must drop exactly n - cap rows"


def test_shell_drop_watermark_on_budget_exhaustion():
    """A budget that holds both occupied tiles but not their relay loses no
    particle, so only the shell_drop watermark can see it."""
    cfg, _, _, _, dom = _case(2, 8, seed=1)
    pos = np.zeros((8, 2), np.float32)
    pos[:4] = [5.0, 5.0]
    pos[4:] = [10.0, 10.0]
    p = tstate.from_numpy(pos, device="cpu")
    _, ok = _specs(dom)
    st = tstx.bin_particles(p, dom, ok)
    assert int(st.count.sum()) == 8 and int(st.shell_drop[0]) == 0
    st = tstx.bin_particles(p, dom, tstx.StreamSpec(active=2))
    assert int(st.count.sum()) == 8, "no particle loss — only relays dropped"
    assert int(st.shell_drop[0]) > 0, "relay drop must set the watermark"
