"""PyTorch port, the "sorted" backend against ``fluid_tpu.ops.sorted_transfer``.

Both packages get the same numpy-seeded dam breaks at the sizes of
tests/test_backends.py (the reference configs and domains, 512 particles
for one substep, 1024 for a 2D frame).  The JAX functions run under
``jax.jit`` on the CPU; the sorted backend reaches no Pallas kernel.
Tolerances (tests/test_backends.py's):

* the sort and the segment sum: exact (stable sorts, sums in slot order);
* one substep: pos, vel, C, density and the grid mass 1e-5, pressure 1e-4;
* a frame (31 substeps): 1e-3;
* the port against itself (run, replay): bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain as jmake_domain
from fluid_tpu.ops import sorted_transfer as jso
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate, step as tstep
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import sorted_transfer as tso
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)

FIELDS = ("pos", "vel", "C", "density", "pressure", "mass")
# the seed boxes of fluid_tpu.scene.dam_break
BOX = {2: ((16.0, 16.0), (48.0, 48.0)), 3: ((16.0, 16.0, 16.0), (32.0, 32.0, 32.0))}


def _case(dim, n, seed, iterations=None):
    """A dam break of the reference config: the JAX particles, the port's
    (on the CPU), the config and both domains (``make_domain(cfg)``)."""
    cfg = default_2d() if dim == 2 else default_3d()
    if iterations is not None:
        cfg = cfg.replace(iterations=iterations)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(BOX[dim][0], BOX[dim][1], (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * 0.4).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    jp = JParticles.create(jnp.asarray(pos))
    jp.vel, jp.C = jnp.asarray(vel), jnp.asarray(C)
    tp = tstate.from_numpy(pos, vel, C, device="cpu")
    return cfg, jp, tp, jmake_domain(cfg), make_domain(cfg)


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_by_cell_equals_jax(dim):
    """The sorted state, the sorted cell ids and the inverse permutation
    equal JAX's exactly (stable sorts), with cells shared by particles."""
    cfg, jp, tp, jdom, tdom = _case(dim, 512, seed=0)
    js, jflat, jinv = jax.jit(lambda q: jso.sort_by_cell(q, jdom))(jp)
    ts, tflat, tinv = tso.sort_by_cell(tp, tdom)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert int(torch.unique(tflat).numel()) < tp.n  # shared cells: the sort's ties matter


def test_seg_sum_equals_jax():
    """Segment sums over sorted ids with empty cells and long runs."""
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 50, 400)).astype(np.int64)
    vals = rng.normal(size=(400, 3)).astype(np.float32)
    got = tso._seg_sum(torch.as_tensor(vals), torch.as_tensor(ids), 64)
    want = jso._seg_sum(jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), 64)
    assert tuple(got.shape) == (64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert not got[50:].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_tap_ids_and_masks_equal_jax(dim):
    cfg, jp, tp, jdom, tdom = _case(dim, 512, seed=0)
    js, jflat, _ = jso.sort_by_cell(jp, jdom)
    ts, tflat, _ = tso.sort_by_cell(tp, tdom)
    jids, jvalid, jw, jdpos = jso._tap_ids_and_masks(js, jflat, jdom)
    tids, tvalid, tw, tdpos = tso._tap_ids_and_masks(ts, tflat, tdom)
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7, rtol=0)
    np.testing.assert_allclose(tdpos.numpy(), np.asarray(jdpos), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dim,mouse", [(2, False), (2, True), (3, False)],
                         ids=["2d", "2d-mouse", "3d"])
def test_sorted_substep_matches_jax(dim, mouse):
    """One substep against JAX's sorted substep (through step.substep):
    particles and the grid, at tests/test_backends.py's tolerances."""
    cfg, jp, tp, jdom, tdom = _case(dim, 512, seed=0)
    jm = jstep.mouse((20.0, 30.0)) if mouse else jstep.no_mouse()
    tm = tstep.mouse((20.0, 30.0)) if mouse else tstep.no_mouse()
    a, ga = jax.jit(lambda q, mp, ma: jstep.substep(q, cfg, jdom, mp, ma, backend="sorted"))(jp, *jm)
    b, gb = tstep.substep(tp, cfg, tdom, *tm, backend="sorted")
    for f, atol in (("pos", 1e-5), ("vel", 1e-5), ("C", 1e-5), ("density", 1e-5),
                    ("pressure", 1e-4), ("mass", 0.0)):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), atol=atol,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(gb.mass.numpy(), np.asarray(ga.mass), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.vel.numpy(), np.asarray(ga.vel), atol=1e-5, rtol=0)
    assert abs(float(gb.mass.double().sum()) - tp.n) <= 1e-4 * tp.n


def test_sorted_frame_matches_jax():
    """step.frame through the sorted backend (31 substeps) against JAX's
    sorted frame, at tests/test_backends.py's frame tolerance."""
    cfg, jp, tp, jdom, tdom = _case(2, 1024, seed=3)
    a = jstep.frame(jp, cfg, jdom, *jstep.no_mouse(), "sorted")
    b = tstep.frame(tp, cfg, tdom, *tstep.no_mouse(), "sorted")
    np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), atol=1e-3, rtol=0)
    np.testing.assert_allclose(b.vel.numpy(), np.asarray(a.vel), atol=1e-3, rtol=0)


def test_sorted_session_runs_and_replays():
    """Session(sorted): run(k) equals k frames, equals step.frame, and a
    snapshot replays bit-identically."""
    cfg, _, tp, _, tdom = _case(2, 512, seed=5, iterations=3)
    sa = Session(cfg, tdom, tp.clone(), backend="sorted", device="cpu")
    sb = Session(cfg, tdom, tp.clone(), backend="sorted", device="cpu")
    sa.frame()
    sa.frame()
    sb.run(2)
    want = tstep.frame(tstep.frame(tp, cfg, tdom, *tstep.no_mouse(), "sorted"),
                       cfg, tdom, *tstep.no_mouse(), "sorted")
    snap = sb.snapshot()
    sb.frame()
    first = sb.particles().clone()
    sb.restore(snap)
    sb.frame()
    for f in FIELDS:
        assert torch.equal(getattr(sa.particles(), f), getattr(want, f)), f
        assert torch.equal(getattr(sb.particles(), f), getattr(first, f)), f
    assert sb.live_count() == tp.n and sb.backend == "sorted"


def test_backends_lists_all_five():
    assert tstep.BACKENDS == ("dense", "sorted", "tiled", "stream", "pallas")
    for name in tstep.BACKENDS:
        assert hasattr(tstep._get_backend(name), "substep") or name == "dense"
    with pytest.raises(ValueError, match="unknown transfer backend"):
        tstep._get_backend("nope")
