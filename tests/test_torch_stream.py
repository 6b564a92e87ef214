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
from fluid_tpu_torch.ops import stream_kernels as sk
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


def _keys_before(pos, dom, spec, tshape, vel, dt):
    """The predictive keys as the re-bin computed them before its kernels."""
    shape, origin = torch.as_tensor(dom.shape), torch.as_tensor(dom.origin)

    def _cell(x):
        return torch.minimum((torch.floor(x).to(torch.int64) - origin).clamp_min(0), shape - 1)

    T, h = spec.tile, spec.halo
    cell = _cell(pos)
    ct = _cell(pos + torch.clamp(vel * (6.0 * dt), -1.0, 1.0)) // T
    lc = cell - ct * T
    kt = torch.where((lc >= 1 - h) & (lc <= T - 2 + h), ct, cell // T)
    key = kt[:, 0]
    for d in range(1, len(tshape)):
        key = key * tshape[d] + kt[:, d]
    return key


def _rebin_before(st, cfg, dom, spec, tshape, nt, n):
    """The re-bin as it was before it wrote in place: the live slots
    gathered from the flat slot rows, keyed, sorted, then the slot rows
    gathered, masked and transposed into a new state."""
    A, cap, D = spec.A, spec.cap, cfg.dim
    flat = st.stream.permute(0, 2, 1).reshape(A * cap, -1)
    count = st.count.to(torch.int64)
    cum = torch.cumsum(count, 0)
    b = torch.zeros((n + 1,), dtype=torch.int64)
    b.index_add_(0, cum.clamp(0, n), torch.ones_like(cum))
    a = torch.cumsum(b, 0)[:n].clamp(0, A - 1)
    src = (a * cap + (torch.arange(n) - (cum - count)[a])).clamp(0, A * cap - 1)
    live_rows = flat[src]
    keys = _keys_before(live_rows[:, :D], dom, spec, tshape, live_rows[:, D:2 * D], cfg.dt)
    keys = torch.where(torch.arange(n) < st.count.sum(), keys, nt)

    order = torch.argsort(keys, stable=True)
    start = torch.searchsorted(keys[order], torch.arange(nt + 2), right=False)
    count_t = (start[1:] - start[:-1])[:nt]
    occ_p = count_t > 0
    occ = tstx._active_set(occ_p, tshape)
    shell = occ & ~occ_p
    rank_p = torch.cumsum(occ_p.to(torch.int64), 0) - 1
    rank_s = occ_p.sum() + torch.cumsum(shell.to(torch.int64), 0) - 1
    occ_rank = torch.where(occ_p, rank_p, rank_s)
    act_of_tile = torch.where(occ & (occ_rank < A), occ_rank, A)
    tid_act = torch.full((A,), -1, dtype=torch.int64)
    tid_act.scatter_reduce_(0, act_of_tile.clamp(0, A - 1),
                            torch.where(act_of_tile < A, torch.arange(nt), -1), "amax",
                            include_self=True)
    tid_act = torch.where(tid_act < 0, nt, tid_act)
    count_act = torch.clamp_max(torch.cat([count_t, count_t.new_zeros(1)])[tid_act.clamp(0, nt)], cap)
    s_io = torch.arange(cap)
    srows = flat[src[order]]
    valid = s_io[None, :] < count_act[:, None]
    bidx = (start[:-1][tid_act.clamp(0, nt)][:, None] + s_io[None, :]).clamp(0, n - 1)
    need = occ.sum().reshape(1).to(torch.int32)
    return tstx.StreamState(
        stream=torch.where(valid[..., None], srows[bidx], 0.0).permute(0, 2, 1).contiguous(),
        count=count_act.to(torch.int32), tid=tid_act.to(torch.int32),
        flag=torch.zeros((A, cap)), nbr=tstx._nbr_table(tid_act, tshape, nt, A),
        shell_drop=torch.clamp_min(need - A, 0), need_peak=need,
        fill_peak=count_t.max().reshape(1).to(torch.int32),
        rebins=torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", ["moved", "full-tile", "every-slot", "tight-budget"])
def test_rebin_in_place_equals_rebin_before(dim, case):
    """``_rebin_into`` (the plain versions of its kernels) leaves the state,
    field for field, equal to the re-bin as it was before it wrote in place
    (``_rebin_before`` plus copies), carries the watermarks, counts the
    re-bin, and redeposits p2g_1 into the given windows.  Cases: particles
    moved up to 3 cells, n below A cap; one tile filled to cap; n = A cap,
    every slot (``frame_binned``'s default); an active budget below the
    needed-relay closure, so shell tiles drop."""
    n = 160 if dim == 2 else 256
    cfg, pos, vel, C, dom = _case(dim, n, seed=5, vel_scale=2.0)
    tshape, nt = tstx._tile_geometry(dom, tstx.StreamSpec())
    cap = 128
    if case == "full-tile":  # the tile at cells [12, 16) of every axis, still
        rng = np.random.default_rng(1)
        pos[:cap] = rng.uniform(12.5, 15.5, (cap, dim)).astype(np.float32)
        vel[:cap] = 0.0
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    spec = tstx.StreamSpec(cap=cap, active=nt)
    if case == "tight-budget":
        full = tstx.bin_particles(p, dom, spec, dt=cfg.dt)
        occ = int((full.count > 0).sum())
        spec = tstx.StreamSpec(cap=cap, active=(occ + int(full.need_peak[0])) // 2)
    st = tstx.bin_particles(p, dom, spec, dt=cfg.dt)
    A = spec.A
    g = torch.Generator().manual_seed(dim)
    moved = (torch.rand((A, dim, cap), generator=g) * 6.0 - 3.0)
    if case == "full-tile":
        moved[:, :, :] = 0.0
        moved[st.count < cap] = torch.rand((int((st.count < cap).sum()), dim, cap), generator=g) * 2.0 - 1.0
    st.stream[:, :dim] = (st.stream[:, :dim] + moved).clamp(1.0, 15.0)
    st.flag[:, ::3] = 2.0
    st.need_peak.fill_(1)
    st.fill_peak.fill_(1)
    st.rebins.fill_(5)
    n_arg = A * cap if case == "every-slot" else n

    want = _rebin_before(st, cfg, dom, spec, tshape, nt, n_arg)
    got = st.clone()
    stages = tstx.substep_stages(cfg, dom, spec, "cpu")
    dep1 = torch.full((A, 1 + dim, spec.E**dim), 7.0)
    sk.reset_launches()
    tstx._rebin_into(got, dep1, cfg, dom, spec, tshape, nt, n_arg, stages)
    for k in ("stream", "count", "tid", "flag", "nbr"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got.shell_drop, want.shell_drop)
    assert torch.equal(got.need_peak, want.need_peak) and int(got.need_peak[0]) > 1
    assert torch.equal(got.fill_peak, want.fill_peak) and int(got.fill_peak[0]) > 1
    assert int(got.rebins[0]) == 6
    assert torch.equal(dep1, stages.dep1(want))
    assert not any(sk.LAUNCHES.values())  # the plain versions launch nothing
    assert not torch.equal(got.tid, st.tid) or not torch.equal(got.count, st.count)
    if case == "tight-budget":
        assert int(got.shell_drop[0]) > 0
    else:
        assert int(got.count.sum()) == n
    if case == "full-tile":
        assert int(got.count.max()) == cap
