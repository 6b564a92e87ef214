"""PyTorch port, the "tiled" backend against ``fluid_tpu.ops.tiled_transfer``.

Both packages get the same numpy-seeded scenes at the sizes of
tests/test_tiled.py (a 32-cell box, grid_res 16, halo 4, particles in
[8, 24), tile 4).  The JAX functions run under ``jax.jit`` on the CPU; the
tiled backend reaches no Pallas kernel.  Tolerances (tests/test_tiled.py's
and tests/test_backends.py's):

* binning: exact (stable sorts on both sides);
* the profile contractions ``_deposit`` and ``_collect``: 1e-5;
* one substep: pos, vel, C 1e-5, density, pressure and the grid 1e-4;
* a 3-substep frame: 1e-4, and the port's frame equals its substeps;
* the port against itself (strict, replay): bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain as jmake_domain
from fluid_tpu.ops import tiled_transfer as jtt
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate, step as tstep
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import tiled_transfer as ttt
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)

FIELDS = ("pos", "vel", "C", "density", "pressure", "mass")
ATOL = {"pos": 1e-5, "vel": 1e-5, "C": 1e-5, "density": 1e-4, "pressure": 1e-4, "mass": 0.0}


def _case(dim, n, seed, pos=None):
    """tests/test_tiled.py::_small_case, seeded with numpy: the JAX
    particles, the port's (on the CPU), the config and both domains."""
    base = default_2d() if dim == 2 else default_3d()
    cfg = base.replace(boundary_clip=((0.0,) * dim, (32.0,) * dim), grid_res=16)
    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.uniform(8.0, 24.0, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    jp = JParticles.create(jnp.asarray(pos))
    jp.vel, jp.C = jnp.asarray(vel), jnp.asarray(C)
    tp = tstate.from_numpy(pos, vel, C, device="cpu")
    return cfg, jp, tp, jmake_domain(cfg, halo_cells=4), make_domain(cfg, halo_cells=4)


def _specs(**kw):
    return jtt.TileSpec(**kw), ttt.TileSpec(**kw)


def _mouse(on: bool):
    return (jstep.mouse((16.0, 16.0)), tstep.mouse((16.0, 16.0))) if on else \
        (jstep.no_mouse(), tstep.no_mouse())


def _jax_substep(cfg, dom, spec, preserve_order=True):
    return jax.jit(lambda q, mp, ma: jtt.substep(q, cfg, dom, mp, ma, spec,
                                                 preserve_order=preserve_order))


def _close(got, want, fields=FIELDS, atol=None):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=(atol or ATOL)[f], rtol=0, err_msg=f)


@pytest.mark.parametrize("dim", [2, 3])
def test_bin_particles_with_bsrc_equals_jax(dim):
    """Every array of the binning equals JAX's, the slot gather bsrc too."""
    cfg, jp, tp, jdom, tdom = _case(dim, 384, seed=0)
    js, ts = _specs(tile=4, cap=64)
    jb = jax.jit(lambda x: jtt.bin_particles(x, jdom, js))(jp.pos)
    tb = ttt.bin_particles(tp.pos, tdom, ts)
    for key in ("order", "sid", "start", "tile_of_active", "act_start", "bsrc", "valid", "frozen"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)
    assert tb["tshape"] == jb["tshape"] and tb["n_active"] == jb["n_active"]


@pytest.mark.parametrize("dim", [2, 3])
def test_deposit_and_collect_match_jax(dim):
    """The profile contractions on the same profiles and channels: the
    deposit, its transpose, and the merged 1+D variant forms, to 1e-5."""
    rng = np.random.default_rng(dim)
    A, E, cap, C = 5, 6, 32, 1 + dim
    blc = rng.integers(0, 4, (dim, A, cap))
    dv = rng.uniform(-0.5, 0.5, (dim, A, cap)).astype(np.float32)
    ch = rng.normal(size=(A, C, cap)).astype(np.float32)
    groups = [rng.normal(size=(A, C, cap)).astype(np.float32) for _ in range(1 + dim)]

    def profiles(mod, arr):
        plain, moment = [], []
        for d in range(dim):
            pl, mo = mod._profiles_axis(arr(blc[d]), mod._axis_weights(arr(dv[d])), E)
            plain.append(pl)
            moment.append(mo)
        return plain, moment

    jpl, jmo = profiles(jtt, jnp.asarray)
    tpl, tmo = profiles(ttt, torch.as_tensor)
    for a, b in zip(tpl + tmo, jpl + jmo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)

    blocks = rng.normal(size=(A, E, C * E ** (dim - 1))).astype(np.float32)
    pairs = [
        (ttt._deposit(tpl, torch.as_tensor(ch)), jtt._deposit(jpl, jnp.asarray(ch))),
        (ttt._collect(tpl, torch.as_tensor(blocks), C), jtt._collect(jpl, jnp.asarray(blocks), C)),
        (ttt._deposit_merged(tpl, tmo, [torch.as_tensor(g) for g in groups]),
         jtt._deposit_merged(jpl, jmo, [jnp.asarray(g) for g in groups])),
    ]
    pairs += list(zip(ttt._collect_all_variants(tpl, tmo, torch.as_tensor(blocks), C),
                      jtt._collect_all_variants(jpl, jmo, jnp.asarray(blocks), C)))
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for a, b in zip(ttt._axis_variants(tpl, tmo, 1), jtt._axis_variants(jpl, jmo, 1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dim,mouse", [(2, False), (2, True), (3, False), (3, True)],
                         ids=["2d", "2d-mouse", "3d", "3d-mouse"])
def test_tiled_substep_matches_jax(dim, mouse):
    """One substep against JAX's tiled substep: particles and the grid."""
    cfg, jp, tp, jdom, tdom = _case(dim, 384, seed=0)
    js, ts = _specs(tile=4, cap=64)
    assert int(ttt.overflow_count(tp.pos, tdom, ts)) == 0
    jm, tm = _mouse(mouse)
    a, ga = _jax_substep(cfg, jdom, js)(jp, *jm)
    b, gb = ttt.substep(tp, cfg, tdom, *tm, ts)
    _close(b, a)
    np.testing.assert_allclose(gb.mass.numpy(), np.asarray(ga.mass), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gb.vel.numpy(), np.asarray(ga.vel), atol=1e-4, rtol=0)
    if mouse:  # the mouse acted: the substep differs from one without it
        c, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts)
        assert not torch.equal(b.vel, c.vel)


def test_overflow_freezes_like_jax():
    """cap 8 with 64 particles jammed into one tile: the particles past the
    cap pass through frozen (old state, exactly), as in JAX."""
    rng = np.random.default_rng(9)
    pos = (10.5 + rng.uniform(0.0, 1.0, (64, 2))).astype(np.float32)
    cfg, jp, tp, jdom, tdom = _case(2, 64, seed=3, pos=pos)
    js, ts = _specs(tile=4, cap=8)
    n_over = int(ttt.overflow_count(tp.pos, tdom, ts))
    assert n_over == int(jtt.overflow_count(jp.pos, jdom, js)) > 0
    a, _ = _jax_substep(cfg, jdom, js)(jp, *jstep.no_mouse())
    b, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts)
    _close(b, a)
    assert bool(torch.isfinite(b.pos).all())
    moved = (b.pos - tp.pos).abs().amax(dim=1)
    assert int((moved == 0.0).sum()) >= n_over


def test_active_budget_compaction_matches_jax():
    """A tight active budget (occupied tiles + 2) gives JAX's result."""
    cfg, jp, tp, jdom, tdom = _case(2, 256, seed=4)
    b = ttt.bin_particles(tp.pos, tdom, ttt.TileSpec(tile=4, cap=64))
    occupied = int((b["start"][1:] - b["start"][:-1] > 0).sum())
    js, ts = _specs(tile=4, cap=64, active=occupied + 2)
    assert ttt.bin_particles(tp.pos, tdom, ts)["n_active"] == occupied + 2
    assert int(ttt.overflow_count(tp.pos, tdom, ts)) == 0
    a, _ = _jax_substep(cfg, jdom, js)(jp, *jstep.no_mouse())
    c, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts)
    _close(c, a)
    # a budget one short of the occupied tiles freezes the last tile's particles
    short = ttt.TileSpec(tile=4, cap=64, active=occupied - 1)
    assert int(ttt.overflow_count(tp.pos, tdom, short)) == \
        int(jtt.overflow_count(jp.pos, jdom, jtt.TileSpec(tile=4, cap=64, active=occupied - 1))) > 0


def test_preserve_order_false_matches_jax():
    """Tile-sorted output: JAX's order and values (the binning is equal),
    a permutation of the order-preserving output, and the mass travels."""
    cfg, jp, tp, jdom, tdom = _case(2, 384, seed=6)
    js, ts = _specs(tile=4, cap=64)
    a, _ = _jax_substep(cfg, jdom, js, preserve_order=False)(jp, *jstep.no_mouse())
    b, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts, preserve_order=False)
    _close(b, a)
    keep, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts)
    order = ttt.bin_particles(tp.pos, tdom, ts)["order"]
    assert torch.equal(keep.pos[order], b.pos) and torch.equal(keep.vel[order], b.vel)
    assert float(b.mass.sum()) == tp.n


def test_strict_matches_non_strict_when_no_overflow():
    """strict=True skips the frozen fallback: without overflow the result
    is bit-equal to the non-strict one, and to JAX's strict result."""
    cfg, jp, tp, jdom, tdom = _case(2, 384, seed=7)
    js, ts = _specs(tile=4, cap=64, strict=True)
    assert int(ttt.overflow_count(tp.pos, tdom, ts)) == 0
    a, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ttt.TileSpec(tile=4, cap=64))
    b, _ = ttt.substep(tp, cfg, tdom, *tstep.no_mouse(), ts)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c, _ = _jax_substep(cfg, jdom, js)(jp, *jstep.no_mouse())
    _close(b, c)


def test_tiled_frame_matches_jax():
    """step.frame through the tiled backend (default spec, 3 substeps)
    against JAX's step.frame; the port's frame equals its substeps."""
    cfg, jp, tp, jdom, tdom = _case(2, 512, seed=8)
    cfg = cfg.replace(iterations=3)
    a = jstep.frame(jp, cfg, jdom, *jstep.no_mouse(), "tiled")
    b = tstep.frame(tp, cfg, tdom, *tstep.no_mouse(), "tiled")
    _close(b, a, fields=("pos", "vel", "C"), atol={f: 1e-4 for f in ("pos", "vel", "C")})
    q = tp
    for _ in range(3):
        q, _ = tstep.substep(q, cfg, tdom, *tstep.no_mouse(), backend="tiled")
    for f in FIELDS:
        assert torch.equal(getattr(q, f), getattr(b, f)), f


def test_tiled_session_runs_and_replays():
    """Session(tiled) with a spec: run(k) equals k frames, equals the tiled
    frames of step, and a snapshot replays bit-identically."""
    cfg, _, tp, _, tdom = _case(2, 384, seed=10)
    cfg = cfg.replace(iterations=2)
    spec = ttt.TileSpec(tile=4, cap=64, active=40, strict=True)
    assert int(ttt.overflow_count(tp.pos, tdom, spec)) == 0
    sa = Session(cfg, tdom, tp.clone(), backend="tiled", spec=spec, device="cpu")
    sb = Session(cfg, tdom, tp.clone(), backend="tiled", spec=spec, device="cpu")
    sa.frame()
    sa.frame()
    sb.run(2)
    want = ttt.frame(ttt.frame(tp, cfg, tdom, *tstep.no_mouse(), spec=spec),
                     cfg, tdom, *tstep.no_mouse(), spec=spec)
    snap = sb.snapshot()
    sb.frame()
    first = sb.particles().clone()
    sb.restore(snap)
    sb.frame()
    for f in FIELDS:
        assert torch.equal(getattr(sa.particles(), f), getattr(want, f)), f
        assert torch.equal(getattr(sb.particles(), f), getattr(first, f)), f
    assert sb.live_count() == tp.n and int(ttt.overflow_count(sa.particles().pos, tdom, spec)) == 0
