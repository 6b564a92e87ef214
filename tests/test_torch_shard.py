"""PyTorch port, the dense x-slab path (``parallel/shard.py``) against
``fluid_tpu``: the four tests of tests/test_sharding.py, on CPU shards
(``["cpu"] * s``) against JAX dense at that file's tolerances, from the
same numpy-seeded dam breaks."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step
from fluid_tpu_torch.parallel import shard

torch.set_num_threads(1)

SEED_BOX = {2: ((16.0, 16.0), (48.0, 48.0)), 3: ((16.0, 16.0, 16.0), (32.0, 32.0, 32.0))}


def _dam(make, n, seed):
    """scene.dam_break's seed box, drawn with numpy."""
    cfg = make()
    lo, hi = SEED_BOX[cfg.dim]
    pos = np.random.default_rng(seed).uniform(lo, hi, (n, cfg.dim)).astype(np.float32)
    return cfg, make_domain(cfg), pos


def _jax_dense(cfg, dom, pos, substeps, vel=None):
    mp, ma = jstep.no_mouse()
    return jax.jit(lambda q: jax.lax.fori_loop(
        0, substeps, lambda _, s: jstep.substep(s, cfg, dom, mp, ma)[0], q))(
        JParticles.create(pos, vel=vel))


def _run(cfg, dom, pos, s, substeps, spec=None):
    p = tstate.from_numpy(pos, device="cpu")
    spec = spec or shard.default_spec(dom, s, p.n)
    lps = shard.shard_particles(p, spec, ["cpu"] * s)
    return shard.sharded_frame(lps, cfg, spec, *step.no_mouse(), substeps=substeps), spec


@pytest.mark.parametrize("make,n_dev", [(default_2d, 8), (default_3d, 8), (default_2d, 4)],
                         ids=["2d-8dev", "3d-8dev", "2d-4dev"])
def test_sharded_matches_dense(make, n_dev):
    """4 substeps against JAX dense at 1e-4 (density 1e-3)."""
    cfg, dom, pos = _dam(make, 512, seed=0)
    lps, _ = _run(cfg, dom, pos, n_dev, 4)
    got = shard.gather_particles(lps, 512)
    want = _jax_dense(cfg, dom, pos, 4)
    for name, atol in (("pos", 1e-4), ("vel", 1e-4), ("C", 1e-4), ("density", 1e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("frames", [1, 2], ids=["full-frame-vs-dense", "two-frames-lossless"])
def test_sharded_frames(frames):
    """A full 31-substep frame within 1e-3 of JAX's dense frame, and two
    frames with every particle alive exactly once, finite, mass conserved
    (tests/test_sharding.py's full-frame and migration tests)."""
    cfg, dom, pos = _dam(default_2d, 512 * frames, seed=frames)
    n = pos.shape[0]
    lps, spec = _run(cfg, dom, pos, 8, cfg.iterations)
    for _ in range(frames - 1):
        lps = shard.sharded_frame(lps, cfg, spec, *step.no_mouse())
    uid = torch.cat([lp.uid[lp.alive] for lp in lps])
    assert uid.shape[0] == n and torch.unique(uid).shape[0] == n
    got = shard.gather_particles(lps, n)
    assert bool(torch.isfinite(got.pos).all())
    assert float(got.mass.sum()) == pytest.approx(n, rel=1e-6)
    if frames == 1:
        want = _jax_dense(cfg, dom, pos, cfg.iterations)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-3, rtol=0)


def test_migration_lossless_under_pressure():
    """A tiny migrate_cap and near-full capacity force both backpressure
    paths; emigrants are deferred, never deleted (quirk Q6), and the
    deferral really happens."""
    cfg, dom, pos = _dam(default_2d, 512, seed=3)
    n = pos.shape[0]
    base = shard.default_spec(dom, 8, n)
    cx = np.floor(pos[:, 0]).astype(np.int64) - dom.origin[0]
    occ = np.bincount(np.clip(cx // base.slab, 0, 7), minlength=8).max()
    spec = shard.ShardSpec(domain=dom, n_shards=8, capacity=int(occ) + 8, migrate_cap=2)
    vel = np.zeros_like(pos)
    vel[: n // 2, 0] = 30.0
    vel[n // 2:, 0] = -30.0
    lps = shard.shard_particles(tstate.from_numpy(pos, vel, device="cpu"), spec, ["cpu"] * 8)
    deferred = 0
    for _ in range(8):
        lps = shard.sharded_frame(lps, cfg, spec, *step.no_mouse(), substeps=1)
        uid = torch.cat([lp.uid[lp.alive] for lp in lps])
        assert uid.shape[0] == n and torch.unique(uid).shape[0] == n
        for d, lp in enumerate(lps):
            x = lp.p.pos[lp.alive]
            assert bool(torch.isfinite(x).all())
            cxs = torch.floor(x[:, 0]).long() - dom.origin[0]
            deferred += int(((cxs // spec.slab) != d).sum())
    assert deferred > 0


def test_shard_particles_refuses_overfull_slab():
    cfg, dom, pos = _dam(default_2d, 512, seed=0)
    spec = dataclasses.replace(shard.default_spec(dom, 8, 512), capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        shard.shard_particles(tstate.from_numpy(pos, device="cpu"), spec, ["cpu"] * 8)
