"""PyTorch port, stream specs past 256 slots per tile.

The stream kernels walk a tile's slots in chunks of at most 256, so
``StreamSpec`` takes any cap that is a multiple of 32, as JAX's takes any
multiple of 128 (``fluid_tpu/ops/stream_transfer.py``): bench.py's big-tile
spec (tile 8, cap 1024) among them.  On the CPU the kernels run as their
plain versions, which take any cap; these tests hold the stream path at
such caps against the dense backend at the stream suite's tolerance, 1e-4
(tests/test_session.py).
"""

import numpy as np
import pytest
import torch

from fluid_tpu_torch import scene, step
from fluid_tpu_torch.state import ParticleState
from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as stx
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)


@pytest.mark.parametrize("tile,cap", [(4, 512), (8, 1024), (4, 288)])
def test_stream_spec_takes_caps_past_256(tile, cap):
    spec = stx.StreamSpec(tile=tile, cap=cap, active=64)
    assert (spec.cap, spec.E) == (cap, tile + 4)
    sk.check_cap(cap)
    cfg = default_3d()
    g = stx.tile_geom(make_domain(cfg, halo_cells=4), spec)
    assert g.cap == cap and g.E == tile + 4


def test_stream_session_cap512_matches_dense_across_frames():
    """Two frames of 2 substeps at cap 512: stream and dense agree to 1e-4
    and nothing is lost (test_session_stream_matches_dense_across_frames
    at a cap past 256)."""
    cfg = default_2d().replace(iterations=2, boundary_clip=((0.0, 0.0), (32.0, 32.0)),
                               grid_res=16)
    p, _ = scene.dam_break(torch.Generator().manual_seed(0), cfg, n=512,
                           box=((8.0, 8.0), (24.0, 24.0)), device="cpu")
    dom = make_domain(cfg, halo_cells=4)
    spec = stx.StreamSpec(cap=512, active=64)
    a = Session(cfg, dom, p.clone(), backend="stream", spec=spec, device="cpu")
    b = Session(cfg, dom, p.clone(), backend="dense", device="cpu")
    for _ in range(2):
        a.frame()
        b.frame()
    qa, qb = a.particles(), b.particles()
    np.testing.assert_allclose(qa.pos.numpy(), qb.pos.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(qa.vel.numpy(), qb.vel.numpy(), atol=1e-4, rtol=0)
    assert a.live_count() == 512 and a.shell_drop() == 0
    assert a.stream_state().stream.shape[2] == 512


def test_big_tile_stream_substep_matches_dense():
    """bench.py's big-tile geometry (tile 8, halo 2, cap 1024, E = 12) in
    3D, every particle of the scene in a few tiles: one substep of the
    stream path against dense to 1e-4."""
    cfg = default_3d().replace(boundary_clip=((0.0,) * 3, (16.0,) * 3), grid_res=8)
    rng = np.random.default_rng(4)
    pos = rng.uniform(4.0, 12.0, (800, 3)).astype(np.float32)
    p = ParticleState.create(pos, device="cpu")
    p.vel = torch.as_tensor((rng.normal(size=(800, 3)) * 0.3).astype(np.float32))
    dom = make_domain(cfg, halo_cells=4)
    spec = stx.StreamSpec(tile=8, cap=1024, halo=2, active=27)
    assert int(stx.overflow_count(p.pos, dom, spec, vel=p.vel, dt=cfg.dt)) == 0
    st = stx.bin_particles(p, dom, spec, dt=cfg.dt)
    assert int(st.count.max()) > 256  # a tile holds more than one chunk
    mp, ma = step.no_mouse()
    a = stx.frame(p, cfg, dom, mp, ma, spec=spec, substeps=1)
    b, _ = step.substep(p, cfg, dom, mp, ma, backend="dense")
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-4, rtol=0)
