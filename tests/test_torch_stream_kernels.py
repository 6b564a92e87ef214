"""PyTorch port, the stream kernels' plain versions against the Pallas
kernels they replace (``fluid_tpu/ops/stream_transfer.py``, interpret mode).

Both packages get the same binned state: ``fluid_tpu`` bins a numpy-seeded
scene (world 16, group 2, the geometry of tests/test_stream.py) and the port
takes that state through ``stream_state_from_numpy``.  Each JAX stage output
is then converted to the port's layout and fed to the next port stage, so
every comparison isolates one kernel.  Tolerances:

* deposits and collect: 1e-5 absolute + 1e-5 relative (the Pallas kernels
  contract through the one-window matmul identity, whose cancellation loses
  a few ulp against the direct taps); pressure rows 2e-5 relative instead,
  since the EOS slope 4 k rho^3 / rho0^4 amplifies the density's ulp;
* halo passes: bit-equal (pure adds in halo_pull's order), on the
  occupancy-gated input that both packages' substeps feed them;
* halo_gblk: 1e-6 absolute and relative at occupied tiles, as
  tests/test_stream.py uses (the port divides by m where the Pallas kernel
  multiplies by 1/m), and exact zeros at zero-count tiles.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import scene as jscene
from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.ops import stream_transfer as jstx
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import scene as tscene
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as tstx

torch.set_num_threads(1)

STATE_KEYS = ("stream", "count", "tid", "flag", "nbr", "shell_drop", "need_peak", "rebins")
# the collect variant with the mouse on, on two packed scenes (each scene's
# mouse at its own (8, 8)); packed positions spread to the walls
MOUSE_XY = (8.0, 8.0)
_CACHE = {}


def _scene(dim, n=256, seed=0, vel_scale=0.4, world=16.0):
    rng = np.random.default_rng(seed)
    base = default_2d() if dim == 2 else default_3d()
    cfg = base.replace(
        boundary_clip=((0.0,) * dim, (world,) * dim), grid_res=16,
    )
    pos = rng.uniform(world / 4, world - world / 3, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * vel_scale).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    return cfg, pos, vel, C


def _windows(x, A, CH, dim):
    """A JAX deposit/gblk block array -> the port's [A, CH, E^D] windows."""
    x = np.asarray(x)
    E3 = 8**dim
    if dim == 3:  # rank-3 [.., S1 = 4 rows of 128] per channel
        w = x.reshape(A, -1, 128)[:, : CH * (E3 // 128), :].reshape(A, CH, E3)
    else:  # one EP = 128-lane row per channel
        w = x.reshape(A, -1, 128)[:, :CH, :E3]
    return torch.tensor(w)


def _reference(dim):
    """JAX stage outputs (interpret mode, full grids) on one binned state,
    plus the port's copy of that state.  Cached per dim for this file."""
    if dim in _CACHE:
        return _CACHE[dim]
    cfg, pos, vel, C = _scene(dim)
    dom = make_domain(cfg, halo_cells=4)
    nt = math.prod(s // 4 for s in dom.shape)
    # dyn=False: every program runs, so tiles without particles hold zeros
    # (the port's kernels write zeros there too) instead of interpret NaNs
    spec = jstx.StreamSpec(tile=4, cap=128, halo=2, group=2, active=nt,
                           interpret=True, dyn=False)
    st = jstx.bin_particles(JParticles.create(pos, vel=vel, C=C), dom, spec, dt=cfg.dt)
    stages = jstx.substep_stages(cfg, dom, spec, fused=False)
    fstages = jstx.substep_stages(cfg, dom, spec, fused=True)
    mp, ma = jstep.no_mouse()
    d1 = stages.dep1(st)
    hs_m = stages.halo_m(st, d1)
    d2 = stages.dep2(st, d1, hs_m)
    gblk = stages.halo_gblk(st, d2, hs_m)
    A, D = spec.A, dim
    tspec = tstx.StreamSpec(active=A)
    ref = dict(
        cfg=cfg, dom=dom, spec=spec, st=st, tspec=tspec,
        tst=tstx.stream_state_from_numpy({k: np.asarray(getattr(st, k)) for k in STATE_KEYS}, tspec),
        geom=tstx.tile_geom(dom, tspec),
        d1=_windows(d1, A, 1 + D, D),
        hs_m=torch.as_tensor(np.asarray(hs_m).reshape(A, 1, -1).copy()),
        d2=_windows(d2, A, D, D),
        gblk=_windows(gblk, A, 1 + D, D),
        collect={"plain": stages.collect(st, gblk, mp, ma),
                 "fused": fstages.collect(st, gblk, mp, ma)},
    )
    _CACHE[dim] = ref
    return ref


def _packed_reference(dim, n=256, seed=7):
    """Two 16-unit scenes side by side as ``fluid_tpu`` packs them
    (``pack_scenes``, stride 24, x of scene 1 moved by 24), binned and run
    to the grid values by the JAX stages; its collect with the scene's
    ``scene_stride``, the mouse on at (8, 8) of scene 0 in one call and of
    scene 1 (x + 24) in another (a mouse radius of 10 reaches one scene).
    The port gets the same binned state with each particle in its own
    scene's coordinates (x - 24 in scene 1, exact) and the packed geometry.
    Cached per dim for this file."""
    key = ("packed", dim)
    if key in _CACHE:
        return _CACHE[key]
    cfg, _, _, _ = _scene(dim)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 15.5, (2, n, dim)).astype(np.float32)
    vel = (rng.normal(size=(2, n, dim)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(2, n, dim, dim)) * 0.05).astype(np.float32)
    jp, dom, stride = jscene.pack_scenes(
        jax.vmap(JParticles.create)(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(C)), cfg)
    _, tdom, _ = tscene.pack_scenes(tstate.ParticleState.create(pos, vel=vel, C=C, device="cpu"),
                                    cfg)
    nt = math.prod(s // 4 for s in dom.shape)
    spec = jstx.StreamSpec(tile=4, cap=128, halo=2, group=2, active=nt, interpret=True,
                           dyn=False, scene_stride=stride)
    st = jstx.bin_particles(jp, dom, spec, dt=cfg.dt)
    stages = jstx.substep_stages(cfg, dom, spec, fused=True)
    d1 = stages.dep1(st)
    hs_m = stages.halo_m(st, d1)
    gblk = stages.halo_gblk(st, stages.dep2(st, d1, hs_m), hs_m)
    collects = [stages.collect(st, gblk, *jstep.mouse((MOUSE_XY[0] + k * stride, MOUSE_XY[1])))
                for k in range(2)]
    tspec = tstx.StreamSpec(active=nt, scene_stride=stride)
    tst = tstx.stream_state_from_numpy({k: np.asarray(getattr(st, k)) for k in STATE_KEYS}, tspec)
    geom = tstx.tile_geom(tdom, tspec)
    assert geom.scene_cells == 24
    # each tile's scene offset, and its live slots' x in scene coordinates
    col = (tst.tid.long() // math.prod(geom.tshape[1:])) % geom.tshape[0] * 4
    off = (col // 24 * 24).to(torch.float32)
    live = torch.arange(128)[None, :] < tst.count[:, None]
    tst.stream[:, 0] -= torch.where(live, off[:, None], 0.0)
    ref = dict(cfg=cfg, A=nt, G=spec.group, tst=tst, geom=geom, gblk=_windows(gblk, nt, 1 + dim, dim),
               off=off, scene=(col // 24).numpy(), collects=collects)
    _CACHE[key] = ref
    return ref


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_p2g1_matches_pallas(dim):
    r = _reference(dim)
    st = r["tst"]
    got = sk.deposit_p2g1(st.count, st.tid, st.stream, r["geom"])
    assert float(got.abs().max()) > 0.5  # non-vacuous: real deposits
    _close(got, r["d1"])


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_p2g2_matches_pallas(dim):
    r = _reference(dim)
    st, cfg = r["tst"], r["cfg"]
    params = torch.tensor([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                           cfg.pressure_floor, cfg.dynamic_viscosity], dtype=torch.float32)
    got = sk.deposit_p2g2(st.count, st.tid, st.stream, r["hs_m"], params, r["d1"], r["geom"])
    _close(got, r["d2"])


def _tile_major(x, A, G):
    """A JAX grouped stream [NG, F, G*cap] -> the port's [A, F, cap]."""
    x = np.asarray(x)
    return x.reshape(x.shape[0], x.shape[1], G, -1).transpose(0, 2, 1, 3).reshape(A, x.shape[1], -1)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("variant", ["plain", "fused", "walls"])
def test_collect_matches_pallas(dim, variant):
    """Collect against the JAX collect: its stream and flag against the
    unfused one ("plain"), also its p2g1 windows against the fused one, and
    with the mouse on, on two packed scenes ("walls"): the port's tiles of
    scene 1 hold their particles in that scene's coordinates, and its x rows
    plus the scene's offset match JAX's packed collect, whose x walls shift
    with the scene (``_packed_reference``)."""
    r = _packed_reference(dim) if variant == "walls" else _reference(dim)
    st, cfg = r["tst"], r["cfg"]
    A, G = (r["A"], r["G"]) if variant == "walls" else (r["tspec"].A, r["spec"].group)
    if variant == "walls":
        params = tstx.collect_params(cfg, *tstep.mouse(MOUSE_XY))
    else:
        params = tstx.collect_params(cfg, *tstep.no_mouse())
    got = sk.collect(st.count, st.tid, params, st.stream, r["gblk"], r["geom"])
    if variant == "walls":
        # each scene's tiles from the JAX collect with that scene's mouse
        one, (c0, c1) = r["scene"] == 1, r["collects"]
        ws = np.where(one[:, None, None], _tile_major(c1[0], A, G), _tile_major(c0[0], A, G))
        want = (ws, np.where(one[:, None], np.asarray(c1[1]).reshape(A, -1),
                             np.asarray(c0[1]).reshape(A, -1)),
                torch.where(torch.as_tensor(one)[:, None, None], _windows(c1[2], A, 1 + dim, dim),
                            _windows(c0[2], A, 1 + dim, dim)))
        live = torch.arange(128)[None, :] < st.count[:, None]
        got = (got[0].clone(), got[1], got[2])
        got[0][:, 0] += torch.where(live, r["off"][:, None], 0.0)  # back to packed x
    else:
        want = r["collect"][variant]
        ws = _tile_major(want[0], A, G)
    prs = ws.shape[1] - 1
    _close(got[0][:, :prs], ws[:, :prs], msg="stream rows")
    _close(got[0][:, prs], ws[:, prs], rtol=2e-5, msg="pressure row")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).reshape(A, -1))
    if variant != "plain":
        wp1 = want[2] if variant == "walls" else _windows(want[2], A, 1 + dim, dim)
        _close(got[2], wp1, msg="fused p2g1")
    if variant == "walls":  # non-vacuous: both scenes, the mouse and the walls pushed particles
        assert set(r["scene"][st.count.numpy() > 0].tolist()) == {0, 1}
        calm = sk.collect(st.count, st.tid, tstx.collect_params(cfg, *tstep.no_mouse()),
                          st.stream, r["gblk"], r["geom"])
        assert int((got[0][:, dim:2 * dim] != calm[0][:, dim:2 * dim]).sum()) > 10
        assert float(calm[0][:, 0].max()) <= 16.0  # every scene inside its own walls


def _gated(x, count):
    """numpy windows [A, CH, E^D] with the zero-count tiles' rows zeroed."""
    return np.where((np.asarray(count) > 0)[:, None, None], x, np.float32(0.0))


@pytest.mark.parametrize("dim", [2, 3])
def test_halo_axis_matches_halo_pull(dim):
    """The port's one-launch halo over the D passes is bit-equal to
    halo_pull on the same gated input."""
    r = _reference(dim)
    st, g, A = r["tst"], r["geom"], r["tspec"].A
    rng = np.random.default_rng(dim)
    for CH in (1, dim):
        x = _gated(rng.uniform(-1, 1, (A, CH, g.ncell)).astype(np.float32), st.count)
        want = jstx.halo_pull(jnp.asarray(x.reshape(A, -1)), r["st"].nbr, g.tshape, 4, 8)
        got = sk.halo_axes(torch.as_tensor(x), st.count, st.nbr, g)
        np.testing.assert_array_equal(got.numpy().reshape(A, -1), np.asarray(want))


def _halo_tree(x, gate, nbr, g, update=None):
    """The kernel's evaluation order written out: per output cell, the
    nested sum of the D chained passes, each leaf a raw read of the input
    gated on ``gate`` at the end of a route of neighbour tiles (A reads
    zero).  With ``update`` = (hs_m, dtg), halo_gblk's epilogue: a tile of
    gate 0 reads no mass (m = 0), v = mf/m + dtg where m > 0 else 0, then
    the m row."""
    A = x.shape[0]
    xp = torch.cat([x, torch.zeros_like(x[:1])])
    nbr = torch.cat([nbr.long(), torch.full_like(nbr[:, :1], A, dtype=torch.long)], dim=1)
    e = torch.arange(g.ncell)
    occ = torch.cat([gate > 0, torch.zeros(1, dtype=torch.bool)])

    def node(level, tiles, cells):  # tiles [A] (A = none), cells [ncell]
        if level == 0:
            leaf = xp[tiles][:, :, cells]
            return torch.where(occ[tiles][:, None, None], leaf, 0.0)
        d = level - 1
        stride = g.E ** (g.dim - 1 - d)
        e_d = (e // stride) % g.E
        shift = g.tile * stride
        acc = node(d, tiles, cells)
        yp = node(d, nbr[2 * d][tiles], (cells - shift).clamp(0, g.ncell - 1))
        acc = acc + torch.where(e_d >= g.tile, yp, 0.0)
        ym = node(d, nbr[2 * d + 1][tiles], (cells + shift).clamp(0, g.ncell - 1))
        return acc + torch.where(e_d < g.E - g.tile, ym, 0.0)

    mf = node(g.dim, torch.arange(A), e)
    if update is None:
        return mf
    hs_m, dtg = update
    m = torch.where(occ[:A, None, None], hs_m, 0.0)
    rows = [torch.where(m[:, 0] > 0.0, mf[:, c] / torch.where(m[:, 0] > 0.0, m[:, 0], 1.0)
                        + float(dtg[c]), 0.0) for c in range(g.dim)]
    return torch.cat([torch.stack(rows, dim=1), m], dim=1)


def _ghost_gate(count, nbr):
    """count plus 1 at every other zero-count face neighbour of an occupied
    tile: the sharded path's gate, whose ghost tiles hold no particle but
    windows the exchange filled."""
    A = count.shape[0]
    near = torch.zeros(A + 1, dtype=torch.bool)
    for row in nbr.long():
        near[row[count > 0]] = True
    ghost = (near[:A] & (count == 0)).nonzero()[::2, 0]
    gate = count.clone()
    gate[ghost] = 1
    return gate


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("channels", ["mass", "momentum"])
@pytest.mark.parametrize("gate", ["count", "ghosts"])
def test_halo_axes_matches_chained_plain_passes(dim, channels, gate):
    """The one-launch halo over the D passes, gated on the count or on the
    count plus ghost tiles, equals the D passes chained through
    halo_axis_plain on the gated input, and so does the kernel's tree
    order, bit for bit; the gate matters (tiles it shuts carry data here,
    and the ghost tiles' data reaches their neighbours)."""
    r = _reference(dim)
    st, g, A = r["tst"], r["geom"], r["tspec"].A
    CH = 1 if channels == "mass" else dim
    rng = np.random.default_rng(10 * dim + CH)
    x = torch.as_tensor(rng.uniform(-1, 1, (A, CH, g.ncell)).astype(np.float32))
    on = st.count if gate == "count" else _ghost_gate(st.count, st.nbr)
    want = _gated(x.numpy(), on)
    for d in range(dim):
        want = sk.halo_axis_plain(torch.as_tensor(want), st.nbr[2 * d], st.nbr[2 * d + 1], g, d)
    kw = {} if gate == "count" else {"gate": on}
    got = sk.halo_axes(x, st.count, st.nbr, g, **kw)
    assert torch.equal(got, want)
    assert torch.equal(_halo_tree(x, on, st.nbr, g), want)
    ungated = x
    for d in range(dim):
        ungated = sk.halo_axis_plain(ungated, st.nbr[2 * d], st.nbr[2 * d + 1], g, d)
    assert int((on == 0).sum()) > 0 and not torch.equal(ungated, want)
    if gate == "ghosts":
        assert int((on != st.count).sum()) > 0
        occ = st.count > 0
        assert not torch.equal(got[occ], sk.halo_axes(x, st.count, st.nbr, g)[occ])


@pytest.mark.parametrize("dim", [2, 3])
def test_halo_gblk_matches_pallas_interpret(dim):
    """The whole m+f halo and the grid update in one call, against the JAX
    chain on the same gated random windows with zero-mass cells mixed in:
    in 3D D-1 _make_halo_axis passes and _make_halo_gblk (interpret), in 2D
    halo_pull and the grid update in numpy.  Occupied tiles agree at 1e-6
    absolute and relative, zero-count tiles are exactly zero; and the
    kernel's tree order with the epilogue equals halo_gblk_plain bit for
    bit, also on ungated input (the gate matters there)."""
    r = _reference(dim)
    st, g, A, cfg, spec = r["tst"], r["geom"], r["tspec"].A, r["cfg"], r["spec"]
    D = dim
    rng = np.random.default_rng(11)
    raw = rng.normal(size=(A, D, g.ncell)).astype(np.float32)
    mf = _gated(raw, st.count)
    m = np.maximum(rng.uniform(-0.5, 2.0, (A, 1, g.ncell)), 0.0).astype(np.float32)
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)
    jnbr = r["st"].nbr
    if D == 3:
        S1 = g.ncell // 128
        x = jnp.asarray(mf.reshape(A, D * S1, 128))
        for d in range(D - 1):
            x = jstx._make_halo_axis(spec, D, d, D)(x, jnbr[2 * d], jnbr[2 * d + 1])
        want = jstx._make_halo_gblk(spec, D, D - 1, cfg.dt, cfg.gravity)(
            x, jnp.asarray(m.reshape(A, S1, 128)), jnbr[2 * (D - 1)], jnbr[2 * (D - 1) + 1]
        )
        want = np.asarray(want).reshape(A, 1 + D, g.ncell)
    else:
        hs = np.asarray(jstx.halo_pull(jnp.asarray(mf.reshape(A, -1)), jnbr, g.tshape, 4, 8))
        hs = hs.reshape(A, D, g.ncell)
        v = np.where(m > 0.0, hs / np.where(m > 0.0, m, np.float32(1.0)) + dtg[None, :, None],
                     np.float32(0.0))
        want = np.concatenate([v, m], axis=1)
    got = sk.halo_gblk(torch.as_tensor(mf), torch.as_tensor(m), st.count, st.nbr, dtg, g)
    occ = st.count.numpy() > 0
    assert 0 < int(occ.sum()) < A and (m[occ] == 0.0).any()  # non-vacuous
    _close(got.numpy()[occ], want[occ], atol=1e-6, rtol=1e-6)
    assert int(torch.count_nonzero(got[torch.as_tensor(~occ)])) == 0
    for x in (torch.as_tensor(mf), torch.as_tensor(raw)):
        plain = sk.halo_gblk_plain(x, torch.as_tensor(m), st.count, st.nbr, dtg, g)
        tree = _halo_tree(x, st.count, st.nbr, g, update=(torch.as_tensor(m), dtg))
        assert torch.equal(tree, plain)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dim", [2, 3])
def test_collect_from_port_gblk_matches_pallas(dim):
    """Collect on the port's grid values (zeros at zero-count tiles) from
    the JAX stages' m+f windows and masses gives the particles the JAX
    grid values give: no valid slot reads a zero-count tile's window."""
    r = _reference(dim)
    st, cfg, g = r["tst"], r["cfg"], r["geom"]
    gblk = sk.halo_gblk(r["d2"], r["hs_m"], st.count, st.nbr,
                        sk.gravity_step(cfg.dt, cfg.gravity), g)
    occ = st.count > 0
    _close(gblk[occ], r["gblk"][occ], atol=1e-6, rtol=1e-6)
    assert not torch.equal(gblk, r["gblk"])  # the JAX chain fills zero-count tiles
    params = tstx.collect_params(cfg, *tstep.no_mouse())
    got = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
    want = sk.collect(st.count, st.tid, params, st.stream, r["gblk"], g)
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("cap", [128, 256])
def test_collect_in_place_writes_only_live_slots(dim, cap):
    """The collect into the state's own stream and flag (``out``) gives the
    out-of-place collect's live rows, flags and p2g1 windows bit for bit,
    and leaves every slot past a tile's count as it found it (a sentinel
    here; zeros in every state the port keeps); every live flag is
    written."""
    cfg, pos, vel, C = _scene(dim)
    dom = make_domain(cfg, halo_cells=4)
    spec = tstx.StreamSpec(cap=cap, active=math.prod(s // 4 for s in dom.shape))
    st = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, spec, dt=cfg.dt)
    stages = tstx.substep_stages(cfg, dom, spec, "cpu")
    d1 = stages.dep1(st)
    hs_m = stages.halo_m(st, d1)
    gblk = stages.halo_gblk(st, stages.dep2(st, d1, hs_m), hs_m)
    params = tstx.collect_params(cfg, *tstep.mouse(MOUSE_XY))
    want = stages.collect(st, gblk, params)
    live = torch.arange(cap)[None, :] < st.count[:, None]
    assert live.any() and (~live).any()  # non-vacuous
    sentinel = -7.5
    got = st.clone()
    got.stream.masked_fill_(~live[:, None, :], sentinel)
    got.flag.fill_(sentinel)
    outs = stages.collect(got, gblk, params, (got.stream, got.flag))
    assert outs[0] is got.stream and outs[1] is got.flag
    assert torch.equal(torch.where(live[:, None, :], got.stream, 0.0), want[0])
    assert torch.equal(torch.where(live, got.flag, 0.0), want[1])
    assert bool((got.stream.permute(0, 2, 1)[~live] == sentinel).all())
    assert bool((got.flag[~live] == sentinel).all())
    assert int(want[0].permute(0, 2, 1)[~live].count_nonzero()) == 0
    occ = int(st.occupied[0])  # the p2g1 windows past it are undefined
    assert torch.equal(outs[2][:occ], want[2][:occ])


@pytest.mark.parametrize("bad", ["count_dtype", "count_shape", "nbr_shape", "gate_dtype",
                                 "gate_shape"])
def test_halo_axes_rejects_bad_arguments(bad):
    r = _reference(2)
    st, g = r["tst"], r["geom"]
    x = r["d1"][:, :1].contiguous()
    args = {"count": st.count, "nbr": st.nbr, "gate": None}
    if bad == "count_dtype":
        args["count"] = st.count.long()
    elif bad == "count_shape":
        args["count"] = torch.cat([st.count, st.count[:1]])
    elif bad == "nbr_shape":
        args["nbr"] = st.nbr[:2].contiguous()
    elif bad == "gate_dtype":
        args["gate"] = st.count.float()
    else:
        args["gate"] = st.count[1:].contiguous()
    with pytest.raises(TypeError if bad.endswith("dtype") else ValueError):
        sk.halo_axes(x, args["count"], args["nbr"], g, gate=args["gate"])


def test_wrappers_check_their_inputs():
    """The wrappers reject wrong dtype, shape and layout, and any device
    other than the CPU (plain) or CUDA (kernel)."""
    r = _reference(2)
    st, g = r["tst"], r["geom"]
    with pytest.raises(TypeError):
        sk.deposit_p2g1(st.count.long(), st.tid, st.stream, g)
    with pytest.raises(ValueError):
        sk.deposit_p2g1(st.count, st.tid, st.stream[:, :-1].contiguous(), g)
    with pytest.raises(ValueError):
        sk.halo_axes(r["d1"].transpose(0, 1), st.count, st.nbr, g)
    with pytest.raises(ValueError):
        sk.deposit_p2g1(st.count.to("meta"), st.tid.to("meta"), st.stream.to("meta"), g)
    dtg = sk.gravity_step(0.1, (0.0, 1.0))
    m = r["d1"][:, :1].contiguous()
    with pytest.raises(ValueError):  # 1 + D channels: the p2g1 windows, not the m+f ones
        sk.halo_gblk(r["d1"], m, st.count, st.nbr, dtg, g)
    with pytest.raises(TypeError):
        sk.halo_gblk(r["d2"], m, st.count.long(), st.nbr, dtg, g)
    with pytest.raises(ValueError):
        sk.halo_gblk(r["d2"], m, st.count, st.nbr[:2].contiguous(), dtg, g)
    with pytest.raises(ValueError):
        sk.halo_gblk(r["d2"], r["d1"][:, :2].contiguous(), st.count, st.nbr, dtg, g)
    assert all(v == 0 for v in sk.LAUNCHES.values())  # plain versions count nothing


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_p2g1_into_out_equals_fresh(dim):
    """``deposit_p2g1`` with an output tensor writes into it and returns it,
    equal to the windows it returns without one."""
    r = _reference(dim)
    st, g = r["tst"], r["geom"]
    out = torch.full((st.count.shape[0], 1 + dim, g.ncell), float("nan"))
    got = sk.deposit_p2g1(st.count, st.tid, st.stream, g, out)
    assert got is out
    assert torch.equal(out, sk.deposit_p2g1(st.count, st.tid, st.stream, g))


def _substep_outputs(st, g, cfg, occupied):
    """The five kernels' outputs on ``st``, each stage fed the previous
    stage's output, bounded by ``occupied`` (None: every entry)."""
    params6 = torch.tensor([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                            cfg.pressure_floor, cfg.dynamic_viscosity], dtype=torch.float32)
    params = tstx.collect_params(cfg, *tstep.mouse(MOUSE_XY))
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)
    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g, occupied=occupied)
    hs_m = sk.halo_axes(d1[:, :1].contiguous(), st.count, st.nbr, g, occupied=occupied)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, hs_m, params6, d1, g, occupied=occupied)
    gblk = sk.halo_gblk(d2, hs_m, st.count, st.nbr, dtg, g, occupied=occupied)
    stream, flag, dep = sk.collect(st.count, st.tid, params, st.stream, gblk, g,
                                   occupied=occupied)
    return {"dep1": d1, "halo_m": hs_m, "dep2": d2, "gblk": gblk, "stream": stream, "flag": flag,
            "dep1_next": dep}


@pytest.mark.parametrize("dim", [2, 3])
def test_kernels_bounded_by_occupied(dim):
    """Bounded by the state's ``occupied``, each stage's rows below it are
    bit-equal to the launch over every entry, fed the bounded stages'
    outputs (NaN past the count); a new window's rows past it are NaN (the
    plain versions' mark of "undefined"); the stream and flag are whole; a
    written ``out`` keeps its rows past the count.  Without ``occupied``
    the windows of count-0 entries hold zeros (the m+f halo and the
    deposits) or the relayed halo sums (the mass halo)."""
    r = _reference(dim)
    st, g, cfg = r["tst"], r["geom"], r["cfg"]
    occ = int(st.occupied[0])
    assert 0 < occ == int((st.count > 0).sum()) < st.count.shape[0]
    full = _substep_outputs(st, g, cfg, None)
    got = _substep_outputs(st, g, cfg, st.occupied)
    for k in full:
        assert torch.equal(got[k][:occ], full[k][:occ]), k
        if k in ("stream", "flag"):
            assert torch.equal(got[k], full[k]), k
        else:
            assert bool(torch.isnan(got[k][occ:]).all()), k
            assert bool(torch.isfinite(full[k]).all()), k
    for k in ("dep1", "dep2", "gblk", "dep1_next"):
        assert not bool(full[k][occ:].any()), k
    assert bool(full["halo_m"][occ:].any())  # relays carry the halo's sums
    out = torch.full_like(full["dep1"], 7.0)
    assert sk.deposit_p2g1(st.count, st.tid, st.stream, g, out, occupied=st.occupied) is out
    assert torch.equal(out[:occ], full["dep1"][:occ]) and bool((out[occ:] == 7.0).all())


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrappers_reject_a_bad_occupied(bad):
    """``occupied`` is a [1] int32 tensor on the state's device."""
    r = _reference(2)
    st, g = r["tst"], r["geom"]
    occ = st.occupied.long() if bad == "dtype" else st.occupied.repeat(2)
    err = TypeError if bad == "dtype" else ValueError
    x = r["d1"][:, :1].contiguous()
    dtg = sk.gravity_step(0.1, (0.0, 1.0))
    params = tstx.collect_params(r["cfg"], *tstep.no_mouse())
    for call in (lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g, occupied=occ),
                 lambda: sk.halo_axes(x, st.count, st.nbr, g, occupied=occ),
                 lambda: sk.halo_gblk(r["d2"], x, st.count, st.nbr, dtg, g, occupied=occ),
                 lambda: sk.collect(st.count, st.tid, params, st.stream, r["gblk"], g,
                                    occupied=occ)):
        with pytest.raises(err):
            call()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("rows", ["past-live", "below-live"])
def test_rebin_gather_compacts_and_keys_live_slots(dim, rows):
    """``rebin_gather``: the live slots in slot order and their predictive
    keys (``_keys_from_pos`` at the frame's dt, as int32); past the live
    count, zero rows keyed nt; with fewer rows than live slots, the first
    ones.  ``rebin_fill`` then rebuilds the binned stream from them."""
    r = _reference(dim)
    st, g, cfg, dom, tspec = r["tst"], r["geom"], r["cfg"], r["dom"], r["tspec"]
    live = int(st.count.sum())
    n = live + 40 if rows == "past-live" else live - 30
    got_rows, got_keys = sk.rebin_gather(st.stream, st.count, n, g, 6.0 * cfg.dt)
    a_idx, s_idx = (torch.arange(g.cap)[None, :] < st.count[:, None]).nonzero(as_tuple=True)
    want = st.stream.permute(0, 2, 1)[a_idx, s_idx][:n]
    m = want.shape[0]
    assert got_rows.shape == (n, g.F) and got_keys.dtype == torch.int32
    assert torch.equal(got_rows[:m], want) and not got_rows[m:].any()
    tshape, nt = tstx._tile_geometry(dom, tspec)
    keys = tstx._keys_from_pos(want[:, :dim], dom, tspec, tshape, vel=want[:, dim:2 * dim], dt=cfg.dt)
    assert torch.equal(got_keys[:m], keys.to(torch.int32)) and bool((got_keys[m:] == nt).all())
    if rows == "past-live":  # the stream was binned by these keys: filling from them restores it
        order = torch.argsort(got_keys, stable=True)
        start = torch.cumsum(st.count.long(), 0) - st.count.long()
        stream, flag = torch.full_like(st.stream, 5.0), torch.full_like(st.flag, 2.0)
        sk.rebin_fill(got_rows, order, start, st.count, stream, flag)
        assert torch.equal(stream, st.stream) and not flag.any()
    assert not any(sk.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["gather_count_dtype", "gather_stream_shape", "gather_device",
                                 "gather_no_rows", "fill_order_dtype", "fill_start_shape",
                                 "fill_rows_width", "fill_flag_shape", "fill_layout", "fill_device",
                                 "p2g1_out_shape", "p2g1_out_dtype"])
def test_rebin_wrappers_reject_bad_arguments(bad):
    """The re-bin's wrappers and ``deposit_p2g1``'s output reject a wrong
    dtype (TypeError), shape, layout or device (ValueError), and launch
    nothing."""
    r = _reference(3)
    st, g = r["tst"], r["geom"]
    A, n = st.count.shape[0], int(st.count.sum())
    rows = torch.zeros((n, g.F))
    order, start = torch.arange(n), torch.zeros((A,), dtype=torch.int64)
    stream, flag = torch.empty_like(st.stream), torch.empty_like(st.flag)
    calls = {
        "gather_count_dtype": lambda: sk.rebin_gather(st.stream, st.count.long(), n, g, 0.1),
        "gather_stream_shape": lambda: sk.rebin_gather(st.stream[:, 1:].contiguous(), st.count, n,
                                                       g, 0.1),
        "gather_device": lambda: sk.rebin_gather(st.stream.to("meta"), st.count.to("meta"), n, g,
                                                 0.1),
        "gather_no_rows": lambda: sk.rebin_gather(st.stream, st.count, 0, g, 0.1),
        "fill_order_dtype": lambda: sk.rebin_fill(rows, order.int(), start, st.count, stream, flag),
        "fill_start_shape": lambda: sk.rebin_fill(rows, order, start[1:], st.count, stream, flag),
        "fill_rows_width": lambda: sk.rebin_fill(rows[:, 1:].contiguous(), order, start, st.count,
                                                 stream, flag),
        "fill_flag_shape": lambda: sk.rebin_fill(rows, order, start, st.count, stream, flag[1:]),
        "fill_layout": lambda: sk.rebin_fill(rows, order, start, st.count,
                                             stream.transpose(1, 2).contiguous().transpose(1, 2),
                                             flag),
        "fill_device": lambda: sk.rebin_fill(*(t.to("meta") for t in (rows, order, start, st.count,
                                                                       stream, flag))),
        "p2g1_out_shape": lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g,
                                                  torch.empty((A, 1, g.ncell))),
        "p2g1_out_dtype": lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g,
                                                  torch.empty((A, 4, g.ncell), dtype=torch.float64)),
    }
    with pytest.raises(TypeError if bad.endswith("dtype") else ValueError):
        calls[bad]()
    assert not any(sk.LAUNCHES.values())
