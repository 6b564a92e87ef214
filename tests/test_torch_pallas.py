"""PyTorch port, the "pallas" backend against ``fluid_tpu``'s
(``ops/pallas_transfer.py`` in interpret mode, ``ops/tiled_transfer.py``).

Both packages get the same numpy-seeded scenes (the sizes of
tests/test_pallas.py: 2D world 24, 3D world 16, cap 64).  The kernel tests
bin once per dimension in JAX, run the JAX glue of ``pt.substep`` with its
Pallas kernels in interpret mode, and hand every kernel's inputs, as numpy,
to the port's plain version, so each comparison isolates one kernel.
Tolerances:

* binning: exact (stable sorts on both sides);
* kernels: 1e-5 absolute + 1e-5 relative (the Pallas kernels contract a
  one-hot window matrix, the port sums the taps directly: a few ulp);
* substep against JAX's: pos, vel, C 1e-5, density, pressure and the grid
  1e-4 (tests/test_pallas.py's tolerances);
* a 3-iteration frame against JAX dense: 1e-3 (tests/test_backends.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain as jmake_domain
from fluid_tpu.ops import pallas_transfer as jpt
from fluid_tpu.ops import tiled_transfer as jtt
from fluid_tpu.ops import tiling as jtiling
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import pallas_kernels as pk
from fluid_tpu_torch.ops import pallas_transfer as tpt
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import tiled_transfer as ttt
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)

CAP = 64
MOUSE = {2: (12.0, 12.0), 3: (8.0, 8.0)}
_CACHE = {}


def _case(dim, n=384, seed=0):
    """tests/test_pallas.py::_case, seeded with numpy."""
    base = default_2d() if dim == 2 else default_3d()
    world = 24.0 if dim == 2 else 16.0
    cfg = base.replace(boundary_clip=((0.0,) * dim, (world,) * dim),
                       grid_res=16 if dim == 2 else 12)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(world / 4, world * 3 / 4, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    return cfg, pos, vel, C


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, order="C"), dtype=dtype)


def _reference(dim):
    """One JAX binning and the JAX glue of ``pt.substep`` around the three
    interpret-mode kernels; every kernel's inputs and outputs as numpy."""
    if dim in _CACHE:
        return _CACHE[dim]
    cfg, pos, vel, C = _case(dim)
    jdom = jmake_domain(cfg, halo_cells=4)
    spec = jtt.TileSpec(tile=4, cap=CAP)
    D, T, n = dim, 4, pos.shape[0]
    E = T + 2
    b = jtt.bin_particles(jnp.asarray(pos), jdom, spec)
    tshape, nt = jtt._tile_geometry(jdom, spec)
    A = b["n_active"]
    origin = tuple(int(o) for o in jdom.origin)
    packed = np.concatenate([pos, vel, C.reshape(n, D * D), np.ones((n, 1), np.float32)], 1)
    sorted_packed = packed[np.asarray(b["order"])]

    def lane_pad(rows):  # the JAX stream: cap zero rows, lanes padded to 128
        x = np.concatenate([rows, np.zeros((CAP, rows.shape[1]), np.float32)])
        return jnp.asarray(np.pad(x, ((0, 0), (0, 128 - x.shape[1]))))

    count = b["start"][1:] - b["start"][:-1]
    toa = b["tile_of_active"]
    act_count = jnp.take(jnp.append(count, 0), jnp.clip(toa, 0, nt))
    tid = jnp.clip(toa, 0, nt - 1).astype(jnp.int32)
    kw = dict(D=D, T=T, cap=CAP, interpret=True)
    tiles = (b["act_start"], act_count, tid)
    stream = lane_pad(sorted_packed)
    blocks1 = jpt.deposit(stream, *tiles, tshape, origin, mode="p2g1", **kw)

    emask = jnp.concatenate([jtiling.edge_mask(tshape, T).reshape(nt, -1), jnp.zeros((1, E**D))])
    emask_act = jnp.take(emask, toa, axis=0)[..., None]

    def halo(blocks, CH):
        dense = jnp.zeros((nt + 1, E**D * CH)).at[toa].add(blocks.reshape(A, -1))
        hs = jtiling.halo_sum(dense[:nt].reshape((nt,) + (E,) * D + (CH,)), tshape, T)
        x = jnp.concatenate([hs.reshape(nt, -1), jnp.zeros((1, E**D * CH))])
        return jnp.take(x, toa, axis=0).reshape(A, E**D, CH) * emask_act

    act1 = halo(blocks1, 1 + D)
    mblocks = act1[..., 0:1]
    params6 = jnp.asarray([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                           cfg.pressure_floor, cfg.dynamic_viscosity], jnp.float32)
    blocks2 = jpt.p2g2(stream, mblocks, *tiles[:2], tid, params6, tshape, origin, **kw)
    mom = act1[..., 1:] + halo(blocks2, D)
    g = jnp.asarray(cfg.gravity, jnp.float32)
    vblocks = jnp.where(mblocks > 0.0, mom / jnp.where(mblocks > 0.0, mblocks, 1.0) + cfg.dt * g, 0.0)

    def params_c(mouse):
        mp, ma = jstep.no_mouse() if mouse is None else jstep.mouse(mouse)
        lo, hi = cfg.boundary_clip
        return jnp.asarray([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                            cfg.pressure_floor, cfg.mouse_radius, cfg.boundary_damp_dist,
                            float(ma), float(mp[0]), float(mp[1]), *lo, *hi], jnp.float32)

    collected = {m: jpt.collect(stream, vblocks, mblocks, *tiles, params_c(m), tshape, origin, **kw)
                 for m in (None, MOUSE[dim])}

    # a force stream: random A2 and term rows, the sorted positions
    rng = np.random.default_rng(dim)
    force_rows = np.concatenate(
        [rng.normal(size=(n, D + D * D)).astype(np.float32), sorted_packed[:, :D]], 1)
    blocksf = jpt.deposit(lane_pad(force_rows), *tiles, tshape, origin, mode="p2g2", **kw)

    tdom = make_domain(cfg, halo_cells=4)
    tspec = ttt.TileSpec(tile=4, cap=CAP)
    ref = dict(
        cfg=cfg, pos=pos, vel=vel, C=C, jdom=jdom, tdom=tdom, spec=spec, tspec=tspec, b=b,
        geom=sk.TileGeom(dim=D, tile=T, halo=1, cap=CAP, tshape=tshape, origin=origin),
        stream=_t(sorted_packed.T), force=_t(force_rows.T),
        act_start=_t(b["act_start"], torch.int32), act_count=_t(act_count, torch.int32),
        tid=_t(tid, torch.int32), params6=_t(params6),
        params_c={m: _t(params_c(m)) for m in collected},
        mblocks=_t(mblocks), vblocks=_t(vblocks),
        blocks1=np.asarray(blocks1), blocks2=np.asarray(blocks2), blocksf=np.asarray(blocksf),
        collected={m: np.asarray(v) for m, v in collected.items()},
    )
    _CACHE[dim] = ref
    return ref


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("dim,fits", [(2, True), (2, False), (3, True), (3, False)],
                         ids=["2d", "2d-overflow", "3d", "3d-overflow"])
def test_bin_particles_equals_jax(dim, fits):
    """order, sid, start, tile_of_active, act_start, valid and frozen are
    exactly JAX's, and so is overflow_count, with a spec that fits and one
    that overflows both cap and the active budget."""
    cfg, pos, _, _ = _case(dim, seed=5)
    spec = jtt.TileSpec(tile=4, cap=CAP) if fits else jtt.TileSpec(tile=4, cap=8, active=3)
    want = jtt.bin_particles(jnp.asarray(pos), jmake_domain(cfg, halo_cells=4), spec)
    tspec = ttt.TileSpec(**dataclasses.asdict(spec))
    tdom = make_domain(cfg, halo_cells=4)
    got = ttt.bin_particles(torch.as_tensor(pos), tdom, tspec)
    for k in ("order", "sid", "start", "tile_of_active", "act_start", "valid", "frozen"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert (got["tshape"], got["n_active"]) == (want["tshape"], want["n_active"])
    over = int(ttt.overflow_count(torch.as_tensor(pos), tdom, tspec))
    assert over == int(jtt.overflow_count(jnp.asarray(pos), jmake_domain(cfg, halo_cells=4), spec))
    assert (over == 0) == fits


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_p2g1_matches_pallas(dim):
    r = _reference(dim)
    got = pk.deposit(r["stream"], r["act_start"], r["act_count"], r["tid"], r["geom"], mode="p2g1")
    assert float(got[..., 0].max()) > 0.5  # non-vacuous: real deposits
    _close(got, r["blocks1"])


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_force_matches_pallas(dim):
    """K6 in its force mode (JAX ``mode="p2g2"``), from a force stream."""
    r = _reference(dim)
    got = pk.deposit(r["force"], r["act_start"], r["act_count"], r["tid"], r["geom"], mode="force")
    assert float(got.abs().max()) > 0.5
    _close(got, r["blocksf"])


@pytest.mark.parametrize("dim", [2, 3])
def test_p2g2_matches_pallas(dim):
    r = _reference(dim)
    got = pk.p2g2(r["stream"], r["mblocks"], r["act_start"], r["act_count"], r["tid"],
                  r["params6"], r["geom"])
    assert float(got.abs().max()) > 1e-3
    _close(got, r["blocks2"])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mouse", [False, True], ids=["calm", "mouse"])
def test_collect_matches_pallas(dim, mouse):
    """Every output row (zero past count), without and with the mouse."""
    r = _reference(dim)
    key = MOUSE[dim] if mouse else None
    args = (r["stream"], r["vblocks"], r["mblocks"], r["act_start"], r["act_count"], r["tid"])
    got = pk.collect(*args, r["params_c"][key], r["geom"])
    _close(got, r["collected"][key])
    if mouse:  # non-vacuous: the mouse pushed particles
        calm = pk.collect(*args, r["params_c"][None], r["geom"])
        assert int((got[:, dim:2 * dim] != calm[:, dim:2 * dim]).sum()) > 10


@pytest.mark.parametrize("dim,options", [(2, False), (3, False), (2, True)],
                         ids=["2d", "3d", "2d-unordered-strict"])
def test_substep_matches_jax_pallas(dim, options):
    """The whole substep against JAX's ``pt.substep`` (interpret): particles
    and the grid mass; ``options`` runs preserve_order=False with a strict
    spec (particles come back in tile-sorted order, mass with them)."""
    r = _reference(dim)
    cfg, D = r["cfg"], dim
    spec, tspec = r["spec"], r["tspec"]
    if options:
        spec, tspec = (dataclasses.replace(s, strict=True) for s in (spec, tspec))
    mp, ma = jstep.no_mouse()
    a, ga = jpt.substep(JParticles.create(r["pos"], vel=r["vel"], C=r["C"]), cfg, r["jdom"],
                        mp, ma, spec, interpret=True, preserve_order=not options)
    p = tstate.from_numpy(r["pos"], r["vel"], r["C"], device="cpu")
    b, gb = tpt.substep(p, cfg, r["tdom"], *tstep.no_mouse(), tspec, preserve_order=not options)
    for f, tol in (("pos", 1e-5), ("vel", 1e-5), ("C", 1e-5), ("density", 1e-4),
                   ("pressure", 1e-4), ("mass", 0.0)):
        _close(getattr(b, f), getattr(a, f), atol=tol, rtol=0, msg=f)
    _close(gb.mass, ga.mass, atol=1e-4, rtol=0, msg="grid mass")
    _close(gb.vel, ga.vel, atol=1e-4, rtol=0, msg="grid vel")
    if options:
        assert float(b.mass.sum()) == p.n


def test_frame_matches_jax_dense():
    """step.frame(backend="pallas"), 3 iterations, against JAX's dense
    frame (the case of tests/test_backends.py::test_fused_backend_through_step_frame)."""
    cfg = default_2d().replace(iterations=3, boundary_clip=((0.0, 0.0), (32.0, 32.0)), grid_res=16)
    rng = np.random.default_rng(7)
    pos = rng.uniform(8.0, 24.0, (512, 2)).astype(np.float32)
    vel = (rng.normal(size=(512, 2)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(512, 2, 2)) * 0.05).astype(np.float32)
    a = jax.jit(lambda q: jstep.frame(q, cfg, jmake_domain(cfg, halo_cells=4), *jstep.no_mouse(), "dense"))(
        JParticles.create(pos, vel=vel, C=C))
    b = tstep.frame(tstate.from_numpy(pos, vel, C, device="cpu"), cfg, make_domain(cfg, halo_cells=4),
                    *tstep.no_mouse(), "pallas")
    for f in ("pos", "vel"):
        _close(getattr(b, f), getattr(a, f), atol=1e-3, rtol=0, msg=f)


def _session_case():
    cfg, pos, vel, C = _case(2, n=256, seed=4)
    return cfg.replace(iterations=3), tstate.from_numpy(pos, vel, C, device="cpu"), make_domain(cfg, halo_cells=4)


def test_session_pallas_run_equals_frames():
    """Session(backend="pallas"): run(k) is k calls of frame(), bit-identical,
    and the frame is step.frame's."""
    cfg, p, dom = _session_case()
    sa = Session(cfg, dom, p.clone(), backend="pallas", device="cpu")
    sb = Session(cfg, dom, p.clone(), backend="pallas", device="cpu")
    for _ in range(3):
        sa.frame()
    sb.run(3)
    qa, qb = sa.particles(), sb.particles()
    for f in ("pos", "vel", "C", "density", "pressure"):
        assert torch.equal(getattr(qa, f), getattr(qb, f)), f
    q = p
    for _ in range(3):
        q = tstep.frame(q, cfg, dom, *tstep.no_mouse(), "pallas")
    assert torch.equal(q.pos, qa.pos)
    assert (sa.live_count(), sa.shell_drop(), sa.rebins()) == (256, 0, 0)


def test_session_pallas_snapshot_replays_bit_identical():
    cfg, p, dom = _session_case()
    sess = Session(cfg, dom, p, backend="pallas", device="cpu")
    sess.frame(tstep.mouse((12.0, 12.0)))
    snap = sess.snapshot()
    sess.run(2)
    a = sess.particles().clone()
    sess.restore(snap)
    sess.run(2)
    for f in ("pos", "vel", "C", "density", "pressure"):
        assert torch.equal(getattr(a, f), getattr(sess.particles(), f)), f


def test_wrappers_check_their_inputs():
    """The wrappers reject wrong dtype, shape, layout, mode and any device
    other than the CPU (plain) or CUDA (kernel); plain runs count nothing."""
    r = _reference(2)
    s, ac, g = r["stream"], r["act_count"], r["geom"]
    tiles = (r["act_start"], ac, r["tid"])
    with pytest.raises(TypeError):
        pk.deposit(s, r["act_start"], ac.long(), r["tid"], g)
    with pytest.raises(ValueError):
        pk.deposit(s[:-1].contiguous(), *tiles, g)
    with pytest.raises(ValueError):
        pk.deposit(r["force"], *tiles, g, mode="p2g1")
    with pytest.raises(ValueError):
        pk.deposit(s, *tiles, g, mode="p2g2")
    with pytest.raises(ValueError):
        pk.collect(s, r["vblocks"].transpose(1, 2), r["mblocks"], *tiles, r["params_c"][None], g)
    with pytest.raises(ValueError):
        pk.p2g2(s, r["mblocks"], *tiles, r["params6"][:5], g)
    with pytest.raises(ValueError):
        pk.deposit(s.to("meta"), *(t.to("meta") for t in tiles), g)
    assert all(v == 0 for v in pk.LAUNCHES.values())
    assert math.prod(g.tshape) == r["act_count"].shape[0]  # default budget: every tile
