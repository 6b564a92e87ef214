"""PyTorch port, the runtime surface held against ``fluid_tpu``: render,
diagnostics, checkpoints (across the two packages, and resume), the native
engine binding, and the app (headless smoke, timing overlays, the backends
and options it refuses).  Inputs are made with numpy from fixed seeds."""

import dataclasses
import io
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu import checkpoint as jckpt
from fluid_tpu import config as jconfig
from fluid_tpu import diagnostics as jdiag
from fluid_tpu import render as jrender
from fluid_tpu import step as jstep
from fluid_tpu.domain import make_domain as jmake_domain
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import app, checkpoint, diagnostics, native, render, state, step
from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.domain import make_domain
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.state import FIELDS

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _fields(dim, n, seed, lo=16.0, hi=48.0):
    """Every field of a particle state, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "pos": f32(rng.uniform(lo, hi, (n, dim))),
        "vel": f32(rng.normal(0.0, 0.3, (n, dim))),
        "C": f32(rng.normal(0.0, 0.05, (n, dim, dim))),
        "mass": f32(rng.uniform(0.5, 1.5, n)),
        "density": f32(rng.uniform(0.0, 3.0, n)),
        "pressure": f32(rng.normal(0.0, 2.0, n)),
    }


def _pair(fields):
    j = JParticles(**{f: jnp.asarray(a) for f, a in fields.items()})
    t = state.ParticleState(**{f: torch.as_tensor(a) for f, a in fields.items()})
    return j, t


@pytest.mark.parametrize("dim", [2, 3])
def test_render_matches_jax(dim):
    """The console lines equal JAX's, particles outside the console
    skipped, for the default and a non-square viewport."""
    fields = _fields(dim, 2000, seed=dim, lo=-4.0, hi=70.0)
    j, t = _pair(fields)
    assert render.render(t) == jrender.render(j)
    assert render.render(t, (70.0, 50.0), (60, 30)) == jrender.render(j, (70.0, 50.0), (60, 30))
    lines = render.render(t)
    assert len(lines) == 40 and all(len(line) == 80 for line in lines)


@pytest.mark.parametrize("dim", [2, 3])
def test_metrics_match_jax(dim):
    """Every metric within 1e-5 relative of JAX's, and the same summary
    line from the same numbers."""
    j, t = _pair(_fields(dim, 500, seed=10 + dim))
    mj, mt = jdiag.metrics(j), diagnostics.metrics(t)
    assert sorted(mj) == sorted(mt)
    for k in mj:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-5, atol=0, err_msg=k)
    assert diagnostics.format_metrics(mt) == jdiag.format_metrics(
        {k: np.asarray(v) for k, v in mt.items()})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    """A file written by either package loads in the other: every field bit
    for bit, the same config and frame."""
    fields = _fields(3, 300, seed=7)
    j, t = _pair(fields)
    cfg_t = default_3d(iterations=5)
    cfg_j = jconfig.default_3d(iterations=5)
    path = tmp_path / "ckpt.npz"
    if writer == "port":
        checkpoint.save(path, t, cfg_t, frame=11)
        got, cfg, frame = jckpt.load(path)
    else:
        jckpt.save(path, j, cfg_j, frame=11)
        got, cfg, frame = checkpoint.load(path, device="cpu")
        assert got.pos.device.type == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_t) and frame == 11
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), fields[f], err_msg=f)


@pytest.mark.parametrize("backend", ["dense", "stream"])
def test_checkpoint_resume_continues_identically(tmp_path, backend):
    """Run, save, load into a new Session: its next frame equals the next
    frame of a Session built from the same particles in memory, and for
    "dense" the uninterrupted run's, bit for bit."""
    cfg = default_2d(iterations=3, boundary_clip=((0.0, 0.0), (32.0, 32.0)), grid_res=16)
    dom = make_domain(cfg, halo_cells=4)
    f = _fields(2, 256, seed=3, lo=8.0, hi=24.0)
    p = state.from_numpy(f["pos"], f["vel"], f["C"], device="cpu")
    sess = Session(cfg, dom, p, backend=backend, device="cpu")
    sess.run(2)
    checkpoint.save(tmp_path / "c.npz", sess.particles(), cfg, frame=2)
    q, cfg_b, frame = checkpoint.load(tmp_path / "c.npz", device="cpu")
    assert cfg_b == cfg and frame == 2
    resumed = Session(cfg_b, dom, q, backend=backend, device="cpu")
    in_memory = Session(cfg, dom, sess.particles().clone(), backend=backend, device="cpu")
    for s in (sess, resumed, in_memory):
        s.frame()
    a, b = in_memory.particles(), resumed.particles()
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if backend == "dense":
        assert torch.equal(sess.particles().pos, b.pos)


needs_native = pytest.mark.skipif(
    not native.available(), reason="native engine not built (make -C native)")


@needs_native
@pytest.mark.parametrize("dim,mouse", [(2, None), (3, None), (2, (30.0, 30.0))],
                         ids=["2d", "3d", "2d-mouse"])
def test_native_sim_matches_jax_dense(dim, mouse):
    """The C++ engine through the port's binding against JAX's dense
    substep, at the tolerances of tests/test_native.py (pos and vel 1e-5,
    density and pressure 1e-4); ``state()`` is a CPU copy the engine's
    later steps do not touch, and the caller's tensors stay as they were."""
    cfg = default_2d() if dim == 2 else default_3d(boundary_clip=((0.0,) * 3, (24.0,) * 3))
    jcfg = jconfig.Config(**dataclasses.asdict(cfg))
    f = _fields(dim, 384, seed=20 + dim, lo=6.0, hi=18.0)
    p = state.from_numpy(f["pos"], f["vel"], f["C"], device="cpu")
    dom = make_domain(cfg, halo_cells=4)
    sim = native.NativeSim(cfg, p, dom)
    sim.step(substeps=4, mouse=mouse)
    got = sim.state()
    sim.step(substeps=1)
    np.testing.assert_array_equal(p.pos.numpy(), f["pos"])
    assert got.pos.device.type == "cpu" and not np.array_equal(got.pos.numpy(), sim.pos)

    mp, ma = jstep.no_mouse() if mouse is None else jstep.mouse(mouse)
    jdom = jmake_domain(jcfg, halo_cells=4)
    want = jax.jit(lambda q: jax.lax.fori_loop(
        0, 4, lambda _, s: jstep.substep(s, jcfg, jdom, mp, ma)[0], q))(
        JParticles.create(f["pos"], vel=f["vel"], C=f["C"]))
    for name, atol in (("pos", 1e-5), ("vel", 1e-5), ("density", 1e-4), ("pressure", 1e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=atol, rtol=0, err_msg=name)


# the overlay's labels: JAX's dense phases (tests/test_render_app.py), one
# substep time on a fused backend; on the stream Session the recorder's host
# spans of the frame (no device stamps on the CPU), then the frame
LABELS = {
    "dense": ("p2g 1", "p2g 2", "update", "g2p"),
    "pallas": ("substep",),
    "stream": ("render", "mouse", "replay", "check", "sync", "frame"),
}


def test_app_headless_smoke():
    """The app's headless frames on the CPU: a 40x80 non-empty render and a
    frame time per frame, as tests/test_render_app.py checks JAX's."""
    out = io.StringIO()
    app.run(dim=2, n=256, frames=2, headless=True, out=out, device="cpu")
    text = out.getvalue()
    assert "--- frame 0 ---" in text and "--- frame 1 ---" in text
    assert "--- frame 2 ---" not in text and text.count("frame: ") == 2
    block = text.split("--- frame 1 ---\n")[1].splitlines()[:40]
    assert len(block) == 40 and all(len(line) == 80 for line in block)
    assert any(c in "".join(block) for c in ".-=*%$#")


@pytest.mark.parametrize("backend", ["dense", "pallas", "stream"])
def test_app_headless_timing_overlay(backend):
    out = io.StringIO()
    app.run(dim=2, n=128, frames=1, headless=True, timing=True, backend=backend,
            out=out, device="cpu")
    labels = [line.split(":")[0] for line in out.getvalue().splitlines() if line.endswith("ms")]
    assert tuple(labels) == LABELS[backend]


def test_app_main_cpu_flag(capsys):
    app.main(["--cpu", "--dim", "3", "--particles", "128", "--frames", "1", "--headless"])
    text = capsys.readouterr().out
    assert "--- frame 0 ---" in text and "frame: " in text


@pytest.mark.parametrize("argv,module", [
    (["--backend", "sorted"], "M8"), (["--backend", "tiled"], "M8")])
def test_app_refuses_what_is_not_ported(argv, module, capsys):
    """The app refuses no backend of the JAX app any more: sorted and tiled,
    refused until module M8 ported them, run their headless frames on the
    CPU (``--cpu --headless``) through ``step.BACKENDS``."""
    assert argv[1] in step.BACKENDS and module == "M8"
    app.main(["--cpu", "--particles", "256", "--frames", "1", "--headless", *argv])
    text = capsys.readouterr().out
    assert "--- frame 0 ---" in text and text.count("frame: ") == 1
    block = text.split("--- frame 0 ---\n")[1].splitlines()[:40]
    assert len(block) == 40 and any(c != " " for line in block for c in line)


def test_app_without_a_card_exits_non_zero():
    """No fallback: without CUDA and without --cpu the app exits non-zero
    with require_cuda's message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the app runs on it")
    r = subprocess.run([sys.executable, "-m", "fluid_tpu_torch.app", "--dim", "2", "--frames", "1",
                        "--headless"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "--- frame" not in r.stdout
