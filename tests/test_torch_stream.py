"""PyTorch port, the stream backend's glue against ``fluid_tpu``: binning is
bit-identical, the substep and a re-binning frame match the JAX dense
backend, and the conservation / budget watermarks fire like the JAX ones.
The kernels run as their plain versions (CPU tensors)."""

import dataclasses
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
from fluid_tpu_torch import checkpoint
from fluid_tpu_torch import scene as tscene
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as tstx
from fluid_tpu_torch.session import Session

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
    for k in ("stream", "count", "tid", "flag", "nbr", "occupied"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got.shell_drop, want.shell_drop)
    assert torch.equal(got.need_peak, want.need_peak) and int(got.need_peak[0]) > 1
    assert torch.equal(got.fill_peak, want.fill_peak) and int(got.fill_peak[0]) > 1
    assert int(got.rebins[0]) == 6
    # the windows of the occupied entries; the buffer's rows past them are
    # left as they were (undefined: nothing reads them)
    occ = int(got.occupied[0])
    assert 0 < occ == int((got.count > 0).sum())
    assert torch.equal(dep1[:occ], stages.dep1(want)[:occ])
    assert bool((dep1[occ:] == 7.0).all())
    assert not any(sk.LAUNCHES.values())  # the plain versions launch nothing
    assert not torch.equal(got.tid, st.tid) or not torch.equal(got.count, st.count)
    if case == "tight-budget":
        assert int(got.shell_drop[0]) > 0
    else:
        assert int(got.count.sum()) == n
    if case == "full-tile":
        assert int(got.count.max()) == cap


def _packed_case(n=256, seed=11):
    """Two 3D scenes of ``n`` particles packed side by side
    (``scene.pack_scenes``), each in its own coordinates."""
    cfg, _, _, _, _ = _case(3, 8, seed=0)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(3.0, 11.0, (2, n, 3)).astype(np.float32)
    vel = (rng.normal(size=(2, n, 3)) * 0.4).astype(np.float32)
    stack = tstate.ParticleState.create(pos, vel=vel, device="cpu")
    _, dom, _ = tscene.pack_scenes(stack, cfg)
    return cfg, dom, tscene.batch_rows(stack)


@pytest.mark.parametrize("case", ["2d", "3d", "packed", "tight-budget"])
def test_bin_rows_counts_the_occupied_entries_first(case):
    """``_bin_rows`` (through ``bin_particles``, and a re-bin into a
    state's own tensors) sets ``occupied`` to the number of entries with
    count > 0, and those are the first ones; under a budget below the
    occupied tiles every entry is occupied and ``occupied`` is A."""
    if case == "packed":
        cfg, dom, p = _packed_case()
        spec = tstx.default_spec(cfg, dom, p.n)
    else:
        cfg, pos, vel, C, dom = _case(2 if case == "2d" else 3, 256, seed=3, vel_scale=2.0)
        p = tstate.from_numpy(pos, vel, C, device="cpu")
        spec = _specs(dom, active=4 if case == "tight-budget" else None)[1]
    st = tstx.bin_particles(p, dom, spec, dt=cfg.dt)
    tshape, nt = tstx._tile_geometry(dom, spec)
    moved = st.clone()
    moved.occupied.fill_(-1)
    moved.stream[:, :cfg.dim] += 1.5 * torch.where(moved.stream[:, :cfg.dim] != 0.0, 1.0, 0.0)
    again = tstx._rebin_full(moved, cfg, dom, spec, tshape, nt, p.n, out=moved)
    assert again.occupied is moved.occupied  # written in place, as the frame graph reads it
    for s in (st, moved):
        occ = int(s.occupied[0])
        assert s.occupied.dtype == torch.int32 and s.occupied.shape == (1,)
        assert occ == int((s.count > 0).sum()) > 0
        assert bool((s.count[:occ] > 0).all()) and not bool(s.count[occ:].any())
        assert torch.equal(s.occupied, tstx.occupied_of(s.count))
    if case == "tight-budget":
        assert int(st.occupied[0]) == spec.A and int(st.shell_drop[0]) > 0
    else:
        assert int(st.occupied[0]) < spec.A  # relays and unused entries follow


def _bounded_stages(monkeypatch, fill):
    """Patch the five substep wrappers: with ``fill`` a float, each output
    window (and a written ``out`` buffer) gets ``fill`` at and past
    ``occupied``; with ``fill`` None, ``occupied`` is dropped, so every
    entry of A is computed and a zero-count one holds zero windows."""
    names = ("deposit_p2g1", "deposit_p2g2", "collect", "halo_axes", "halo_gblk")
    seen = []

    def wrap(name, orig):
        def call(*args, occupied=None, **kw):
            if fill is None:
                return orig(*args, **kw)
            out = orig(*args, occupied=occupied, **kw)
            win = out[2] if isinstance(out, tuple) else out
            if not (name == "deposit_p2g1" and len(args) > 4 and args[4] is not None):
                # a new output (a written buffer keeps its rows past the count)
                seen.append(bool(torch.isnan(win[int(occupied[0]):]).all()))
            win[int(occupied[0]):] = fill
            return out
        return call

    for name in names:
        monkeypatch.setattr(sk, name, wrap(name, getattr(sk, name)))
    return seen


@pytest.mark.parametrize("dim", [2, 3])
def test_frame_ignores_the_windows_past_occupied(dim, monkeypatch):
    """A frame of 8 substeps with re-bins (``frame_inplace``, the eager
    branch) whose every window buffer holds NaN at and past ``occupied``
    leaves the state bit-equal to the same frame launched over every entry
    of A with zero windows at count 0: no stage reads a window past the
    count."""
    cfg, pos, vel, C, dom = _case(dim, 256, seed=1, vel_scale=4.0, world=12.0)
    _, ts = _specs(dom)
    st0 = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, ts, dt=cfg.dt)
    assert int(st0.occupied[0]) < ts.A  # non-vacuous: entries past the count
    runs = {}
    for fill in (float("nan"), None):
        with monkeypatch.context() as m:
            seen = _bounded_stages(m, fill)
            st = st0.clone()
            tstx.frame_inplace(st, cfg, dom, ts, *tstep.no_mouse(), substeps=8, n=256)
        runs[fill is None] = st
        if fill is not None:
            assert seen and all(seen)  # the plain versions leave NaN there too
    got, want = runs[False], runs[True]
    assert int(got.rebins[0]) > 0
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("dim", [2, 3])
def test_stream_substep_grid_matches_dense_backend(dim):
    """``substep``'s dense grid, summed from the occupied entries' windows
    (the stream's windows past ``occupied`` are NaN on the CPU), matches
    the port's dense backend: 1e-4 on mass and velocity, every value
    finite."""
    cfg, pos, vel, C, dom = _case(dim, 256, seed=0)
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    _, gs = tstep.substep(p, cfg, dom, *tstep.no_mouse(), backend="stream")
    _, gd = tstep.substep(p, cfg, dom, *tstep.no_mouse(), backend="dense")
    assert bool(torch.isfinite(gs.mass).all()) and bool(torch.isfinite(gs.vel).all())
    assert float(gs.mass.sum()) > 0.0
    torch.testing.assert_close(gs.mass, gd.mass, atol=1e-4, rtol=0)
    torch.testing.assert_close(gs.vel, gd.vel, atol=1e-4, rtol=0)


def test_occupied_rides_with_the_state(tmp_path):
    """``clone``, a Session's ``snapshot`` / ``restore``, the numpy round
    trip (``stream_state_to_numpy`` / ``stream_state_from_numpy``) and a
    checkpoint of the particles carry ``occupied``; a state without it (an
    old one, or ``fluid_tpu``'s) derives it from the count."""
    cfg, pos, vel, C, dom = _case(3, 256, seed=2, vel_scale=2.0)
    _, ts = _specs(dom)
    sess = Session(cfg.replace(iterations=4), dom, tstate.from_numpy(pos, vel, C, device="cpu"),
                   backend="stream", spec=ts, device="cpu")
    st = sess.stream_state()
    snap = sess.snapshot()
    occ0 = int(st.occupied[0])
    assert occ0 == int((st.count > 0).sum())
    st.occupied.fill_(0)
    assert int(st.clone().occupied[0]) == 0 and st.clone().occupied is not st.occupied
    sess.restore(snap)
    assert int(st.occupied[0]) == occ0 and sess.stream_state() is st
    sess.run(3)
    assert int(st.occupied[0]) == int((st.count > 0).sum())

    d = tstx.stream_state_to_numpy(st, group=2)
    assert int(d["occupied"][0]) == int(st.occupied[0])
    back = tstx.stream_state_from_numpy(d, ts)
    assert all(torch.equal(getattr(back, f.name), getattr(st, f.name))
               for f in dataclasses.fields(st))
    del d["occupied"]
    old = tstx.stream_state_from_numpy(d, ts)
    assert torch.equal(old.occupied, st.occupied)

    path = tmp_path / "c.npz"
    checkpoint.save(path, sess.particles(), sess.cfg, frame=3)
    q, cfg2, _ = checkpoint.load(path, device="cpu")
    resumed = Session(cfg2, dom, q, backend="stream", spec=ts, device="cpu")
    rs = resumed.stream_state()
    assert int(rs.occupied[0]) == int((rs.count > 0).sum()) > 0
