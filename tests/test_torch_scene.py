"""PyTorch port, batched and packed scenes (``fluid_tpu_torch.scene``) held
against ``fluid_tpu.scene``: a stack of scenes, packing and unpacking
bit-equal to JAX's, and a packed stream frame against each scene run alone
through JAX's dense substep.  Inputs are made with numpy from fixed seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import scene as jscene
from fluid_tpu import step as jstep
from fluid_tpu import config as jconfig
from fluid_tpu.config import default_3d as jdefault_3d
from fluid_tpu.domain import make_domain as jmake_domain
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import scene as tscene
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.ops import stream_transfer as tstx
from fluid_tpu_torch.state import FIELDS, ParticleState

torch.set_num_threads(1)


def _stack(dim, batch, n, seed, lo=3.0, hi=9.0, vel_scale=2.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (batch, n, dim)).astype(np.float32)
    vel = (rng.normal(0.0, 1.0, (batch, n, dim)) * vel_scale).astype(np.float32)
    C = rng.normal(0.0, 0.05, (batch, n, dim, dim)).astype(np.float32)
    return pos, vel, C


def _both(pos, vel, C):
    """The same stack as JAX's vmapped ``ParticleState.create`` and the
    port's ``create`` of a [B, N, D] stack."""
    j = jax.vmap(JParticles.create)(*(jnp.asarray(a) for a in (pos, vel, C)))
    t = ParticleState.create(pos, vel=vel, C=C, device="cpu")
    return j, t


@pytest.mark.parametrize("dim", [2, 3])
def test_create_takes_a_stack_like_jax_vmap(dim):
    j, t = _both(*_stack(dim, 3, 10, seed=dim))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert (t.n, t.dim) == (10, dim)
    with pytest.raises(ValueError):
        ParticleState.create(np.zeros((2, 3, 4, 3), np.float32), device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_pack_and_unpack_scenes_bit_equal_jax(dim):
    """Packed positions, domain and stride equal ``fluid_tpu.scene``'s bit
    for bit (the port's domain also states the scene count and stride),
    every field follows, and unpacking gives JAX's unpacked stack (and the
    input back, to rounding)."""
    cfg = default_2d() if dim == 2 else default_3d()
    jcfg = jconfig.default_2d() if dim == 2 else jconfig.default_3d()
    pos, vel, C = _stack(dim, 3, 40, seed=10 + dim, lo=16.0, hi=48.0)
    j, t = _both(pos, vel, C)
    jp, jdom, jstride = jscene.pack_scenes(j, jcfg)
    tp, tdom, tstride = tscene.pack_scenes(t, cfg)
    assert tstride == jstride == 72.0
    assert dataclasses.asdict(tdom) == dataclasses.asdict(jdom) | {"scenes": 3, "scene_stride": 72}
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    ju = jscene.unpack_scenes(jp, 3, 40, jstride)
    tu = tscene.unpack_scenes(tp, 3, 40, tstride)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tu, f).numpy(), np.asarray(getattr(ju, f)), err_msg=f)
    # x + k stride - k stride rounds once each way: half an ulp at 192
    np.testing.assert_allclose(tu.pos.numpy(), pos, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="stack"):
        tscene.pack_scenes(tp, cfg)


def test_batched_dam_break_and_add_particles():
    """Each scene's block is the seed box shifted by at most ``jitter``
    inside the walls; ``add_particles`` appends like JAX's."""
    cfg = default_3d()
    st, dom = tscene.batched_dam_break(torch.Generator().manual_seed(0), cfg, 8, 256,
                                       device="cpu")
    assert st.pos.shape == (8, 256, 3) and st.mass.shape == (8, 256)
    assert dataclasses.asdict(dom) == dataclasses.asdict(jmake_domain(jdefault_3d()))
    lo = st.pos.amin(dim=1)
    hi = st.pos.amax(dim=1)
    assert bool((lo >= 16.0 - 8.0).all() and (hi <= 32.0 + 8.0).all())
    assert bool(((hi - lo) <= 16.0).all())  # one box per scene, shifted whole
    assert bool((lo >= 0.0).all() and (hi <= 64.0).all())
    assert float(st.vel.abs().max()) == 0.0 and float(st.mass.min()) == 1.0

    pos, vel, C = _stack(3, 1, 24, seed=3)
    extra = _stack(3, 1, 5, seed=4)
    j = jscene.add_particles(JParticles.create(pos[0], vel[0], C[0]), extra[0][0], vel=extra[1][0])
    t = tscene.add_particles(ParticleState.create(pos[0], vel=vel[0], C=C[0], device="cpu"),
                             extra[0][0], vel=extra[1][0])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def test_packed_stream_frame_matches_per_scene_dense():
    """Two scenes packed side by side (each particle in its own scene's
    coordinates, ``batch_rows``; the packed domain's stride) run 3
    substeps of the port's stream path and match each scene run alone
    through ``fluid_tpu``'s dense substep to 1e-3, the tolerance of
    tests/test_stream.py::test_packed_scenes_match_per_scene_dense (12-unit
    worlds, B=2, n=96)."""
    B, n = 2, 96
    cfg = default_3d().replace(boundary_clip=((0.0,) * 3, (12.0,) * 3), grid_res=12)
    jcfg = jdefault_3d().replace(boundary_clip=((0.0,) * 3, (12.0,) * 3), grid_res=12)
    pos, vel, _ = _stack(3, B, n, seed=5)
    stack = ParticleState.create(pos, vel=vel, device="cpu")
    _, dom, stride = tscene.pack_scenes(stack, cfg)
    rows = tscene.batch_rows(stack)
    nt = (dom.shape[0] // 4) * (dom.shape[1] // 4) * (dom.shape[2] // 4)
    spec = tstx.StreamSpec(tile=4, cap=128, halo=2, active=nt, scene_stride=stride)
    assert int(tstx.overflow_count(rows.pos, dom, spec)) == 0
    out = tstx.frame(rows, cfg, dom, *tstep.no_mouse(), spec, substeps=3)
    got = ParticleState(**{f: getattr(out, f).reshape(B, n, *getattr(out, f).shape[1:])
                           for f in FIELDS})
    assert bool((got.pos[..., 0] >= 0.0).all() and (got.pos[..., 0] <= 12.0).all())

    sdom = jmake_domain(jcfg, halo_cells=4)
    mp, ma = jstep.no_mouse()
    dense3 = jax.jit(lambda q: jax.lax.fori_loop(
        0, 3, lambda _, s: jstep.substep(s, jcfg, sdom, mp, ma)[0], q))
    for b in range(B):
        want = dense3(JParticles.create(pos[b], vel=vel[b]))
        np.testing.assert_allclose(got.pos[b].numpy(), np.asarray(want.pos), atol=1e-3, rtol=0)
        np.testing.assert_allclose(got.vel[b].numpy(), np.asarray(want.vel), atol=1e-3, rtol=0)
