"""PyTorch port, core modules: config, domain, bspline, eos, the dense
transfer and step, held against ``fluid_tpu``, the scalar oracle and the
frozen golden trajectories.  Inputs are made with numpy from fixed seeds and
handed to both packages."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import config as jconfig
from fluid_tpu import domain as jdomain
from fluid_tpu import step as jstep
from fluid_tpu.ops import bspline as jbspline
from fluid_tpu.ops import eos as jeos
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import config as tconfig
from fluid_tpu_torch import domain as tdomain
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.ops import bspline as tbspline
from fluid_tpu_torch.ops import eos as teos

from .oracle import OracleSim

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _random_state(dim, n, seed, lo=18.0, hi=(46.0, 46.0, 30.0)):
    """The inputs of tests/test_golden.py::_random_state."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(lo, hi[d], n) for d in range(dim)], axis=-1).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, dim)).astype(np.float32)
    C = rng.normal(0, 0.05, (n, dim, dim)).astype(np.float32)
    return pos, vel, C


def _run_port(cfg, pos, vel, C, substeps, mouse=None):
    dom = tdomain.make_domain(cfg)
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    mp, ma = tstep.no_mouse() if mouse is None else tstep.mouse(mouse)
    for _ in range(substeps):
        p, _ = tstep.substep(p, cfg, dom, mp, ma)
    return p


@pytest.mark.parametrize("name", ["default_2d", "default_3d"])
def test_config_and_domain_equal_jax(name):
    """Fields, defaults and derived domains equal ``fluid_tpu``'s exactly."""
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)
    ]
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    cfg_t = getattr(tconfig, name)()
    cfg_j = getattr(jconfig, name)()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.stencil_size == cfg_j.stencil_size
    for halo in (None, 1, 4):
        dt_, dj = tdomain.make_domain(cfg_t, halo_cells=halo), jdomain.make_domain(cfg_j, halo_cells=halo)
        assert dataclasses.asdict(dt_) == dataclasses.asdict(dj)
        assert dt_.num_cells == dj.num_cells


@pytest.mark.parametrize("dim", [2, 3])
def test_bspline_and_eos_match_jax(dim):
    """Weights, stencil tables, Tait pressure and stress agree to 1e-6."""
    rng = np.random.default_rng(dim)
    diff = rng.uniform(-0.5, 0.5, (64, dim)).astype(np.float32)
    wj = np.asarray(jbspline.quadratic_weights(jnp.asarray(diff)))
    wt = tbspline.quadratic_weights(torch.as_tensor(diff))
    np.testing.assert_allclose(wt.numpy(), wj, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tbspline.stencil_offsets(dim).numpy(), np.asarray(jbspline.stencil_offsets(dim))
    )
    np.testing.assert_allclose(
        tbspline.stencil_weights(wt).numpy(),
        np.asarray(jbspline.stencil_weights(jnp.asarray(wj))), atol=1e-6, rtol=0,
    )
    cfg = jconfig.default_2d() if dim == 2 else jconfig.default_3d()
    rho = rng.uniform(0.0, 3.0 * cfg.rest_density, 64).astype(np.float32)
    args = (cfg.rest_density, cfg.eos_stiffness, cfg.eos_power, cfg.pressure_floor)
    pj = np.asarray(jeos.tait_pressure(jnp.asarray(rho), *args))
    pt = teos.tait_pressure(torch.as_tensor(rho), *args).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=1e-6)
    C = rng.normal(0, 0.3, (64, dim, dim)).astype(np.float32)
    sj = np.asarray(jeos.stress_tensor(jnp.asarray(C), jnp.asarray(pj), cfg.dynamic_viscosity))
    st = teos.stress_tensor(torch.as_tensor(C), torch.tensor(pj), cfg.dynamic_viscosity)
    np.testing.assert_allclose(st.numpy(), sj, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "dim,mouse", [(2, None), (3, None), (2, (30.0, 30.0))], ids=["2d", "3d", "2d-mouse"]
)
def test_dense_substep_matches_jax_dense(dim, mouse):
    """One dense substep (p2g_1, p2g_2, grid_update, g2p) of the port equals
    ``fluid_tpu``'s dense substep to 1e-5: particles and the updated grid."""
    cfg = jconfig.default_2d() if dim == 2 else jconfig.default_3d()
    pos, vel, C = _random_state(dim, 192, seed=21)
    mj = jstep.no_mouse() if mouse is None else jstep.mouse(mouse)
    mt = tstep.no_mouse() if mouse is None else tstep.mouse(mouse)
    a, ga = jax.jit(lambda q: jstep.substep(q, cfg, jdomain.make_domain(cfg), *mj))(
        JParticles.create(pos, vel=vel, C=C)
    )
    b, gb = tstep.substep(tstate.from_numpy(pos, vel, C, device="cpu"), cfg, tdomain.make_domain(cfg), *mt)
    for f in ("pos", "vel", "C", "density", "pressure"):
        np.testing.assert_allclose(
            getattr(b, f).numpy(), np.asarray(getattr(a, f)), atol=1e-5, rtol=1e-5, err_msg=f
        )
    np.testing.assert_allclose(gb.mass.numpy(), np.asarray(ga.mass), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gb.vel.numpy(), np.asarray(ga.vel), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "dim,substeps,tol,mouse",
    [(2, 1, 2e-5, None), (2, 8, 1e-3, None), (3, 1, 2e-5, None), (3, 5, 1e-3, None),
     (3, 3, 1e-4, (30.0, 30.0))],
    ids=["2d-1step", "2d-8steps", "3d-1step", "3d-5steps", "3d-mouse"],
)
def test_dense_matches_oracle(dim, substeps, tol, mouse):
    """The port's dense step against the scalar NumPy oracle, with the
    tolerances of tests/test_golden.py (2e-5 after one substep, 1e-3 over
    several, 1e-4 for the mouse case)."""
    cfg = jconfig.default_2d() if dim == 2 else jconfig.default_3d()
    pos, vel, C = _random_state(dim, 128, seed=7)
    oracle = OracleSim(cfg, pos, vel, C)
    for _ in range(substeps):
        oracle.substep(mouse=mouse)
    got = _run_port(cfg, pos, vel, C, substeps, mouse)
    fields = ("pos", "vel") if mouse else ("pos", "vel", "C", "density", "pressure")
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(oracle, f),
                                   atol=tol, rtol=0, err_msg=f)


@pytest.mark.parametrize("name", ["golden_2d", "golden_3d"])
def test_dense_matches_frozen_golden(name):
    """The frozen oracle trajectories of tests/data at 1e-3."""
    z = np.load(REPO / "tests" / "data" / f"{name}.npz")
    cfg = tconfig.default_2d() if name.endswith("2d") else tconfig.default_3d()
    got = _run_port(cfg, z["pos0"], z["vel0"], z["C0"], int(z["substeps"]))
    for f in ("pos", "vel", "C", "density", "pressure"):
        np.testing.assert_allclose(getattr(got, f).numpy(), z[f], atol=1e-3, rtol=0, err_msg=f)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in no JAX."""
    code = (
        "import sys, fluid_tpu_torch, fluid_tpu_torch.session, "
        "fluid_tpu_torch.ops.stream_transfer, fluid_tpu_torch.ops.pallas_transfer, "
        "fluid_tpu_torch.ops.pallas_kernels, fluid_tpu_torch.ops.tiling, "
        "fluid_tpu_torch.ops.tiled_transfer, fluid_tpu_torch.ops.cuda_build, "
        "fluid_tpu_torch.utils.platform, fluid_tpu_torch.app, fluid_tpu_torch.checkpoint, "
        "fluid_tpu_torch.diagnostics, fluid_tpu_torch.native, fluid_tpu_torch.scene, "
        "fluid_tpu_torch.utils.timing, fluid_tpu_torch.parallel.stream_shard, "
        "fluid_tpu_torch.parallel.shard, fluid_tpu_torch.ops.micro_kernels, "
        "fluid_tpu_torch.micro.micro_sep, fluid_tpu_torch.micro.micro_pb, "
        "fluid_tpu_torch.micro.micro_dma, fluid_tpu_torch.micro.micro_zfac, "
        "fluid_tpu_torch.ops.micro_stream, fluid_tpu_torch.micro.micro_kernels; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fluid_tpu.'))); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("module", ["", ".ops"])
def test_package_surface_holds_jax_surface(module):
    """The port's package and ``ops`` export every name ``fluid_tpu``'s do."""
    import importlib

    jmod = importlib.import_module("fluid_tpu" + module)
    tmod = importlib.import_module("fluid_tpu_torch" + module)
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in jmod.__all__:
        assert hasattr(tmod, name), name


def test_package_version_matches_jax():
    import fluid_tpu
    import fluid_tpu_torch

    assert fluid_tpu_torch.__version__ == fluid_tpu.__version__


@pytest.mark.parametrize("dim", [2, 3])
def test_particle_state_zeros_matches_jax(dim):
    want = JParticles.zeros(5, dim)
    got = tstate.ParticleState.zeros(5, dim, device="cpu")
    for f in tstate.FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.device.type == "cpu"
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f
        assert not g.any(), f
