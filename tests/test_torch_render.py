"""PyTorch port, the console render on the CPU: the byte-table ramp against
the reference's join rule, ``Session.render`` of a stream Session against
the render of its particles and against JAX's, and the live-slot rule of
the stream's histogram (the card's kernel is held against the same plain
version by ``chip_smoke.py``'s render phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_torch import reference
from fluid_tpu import render as jrender
from fluid_tpu_torch import render, scene, step
from fluid_tpu_torch.session import Session

torch.set_num_threads(1)

# (viewport, console): the app's, and a viewport whose sides are no powers of two
VIEWS = [(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE), ((70.0, 50.0), (60, 30))]


@pytest.mark.parametrize("console", [(80, 40), (60, 30), (1, 1)], ids=["80x40", "60x30", "1x1"])
def test_ascii_frame_matches_the_reference_rule(console):
    """Counts 0 to len(RAMP) + 5, past the ramp's end: the lines of the byte
    table equal the reference's ramp character by character."""
    w, h = console
    rng = np.random.default_rng(w * h)
    grids = [rng.integers(0, len(render.RAMP) + 6, (h, w), dtype=np.int32)]
    grids += [np.full((h, w), v, np.int32) for v in range(len(render.RAMP) + 6)]
    for counts in grids:
        want = reference.ascii_lines(torch.from_numpy(counts))
        assert render.ascii_frame(counts) == want
        assert render.ascii_frame(torch.from_numpy(counts)) == want
    assert all(len(line) == w for line in want) and len(want) == h


def _stream_session(dim: int, frames: int = 2):
    make = scene.reference_scene_2d if dim == 2 else scene.reference_scene_3d
    cfg, p, dom = make(seed=dim, n=1024, device="cpu")
    sess = Session(cfg.replace(iterations=3), dom, p, backend="stream", device="cpu")
    for k in range(frames):
        sess.frame(None if k else step.mouse((32.0, 32.0)))
    return sess


@pytest.mark.parametrize("dim", [2, 3])
def test_session_render_matches_particles_and_jax(dim):
    """The stream Session's render, binned from its live slots, equals the
    render of its un-binned particles and JAX's render of them."""
    sess = _stream_session(dim)
    pos = sess.particles().pos
    for viewport, console in VIEWS:
        lines = sess.render(viewport, console)
        assert lines == render.render(sess.particles(), viewport, console)
        want = jrender.ascii_frame(np.asarray(jrender.histogram(
            jnp.asarray(pos.numpy()), jnp.asarray(viewport, jnp.float32), console)))
        assert lines == want
        assert len(lines) == console[1] and all(len(line) == console[0] for line in lines)


@pytest.mark.parametrize("dim", [2, 3])
def test_dead_slots_add_nothing(dim):
    """Slots past each tile's count that hold in-viewport xy (and NaN) add
    nothing: the histogram equals the particles' histogram, on the plain
    version and through console_histogram."""
    sess = _stream_session(dim, frames=1)
    st = sess.stream_state()
    cap = st.stream.shape[-1]
    dead = torch.arange(cap)[None, :] >= st.count[:, None]
    assert int(dead.sum()) > 0
    want = render.histogram(sess.particles().pos).clone()
    st.stream[:, 0, :][dead] = 10.5
    st.stream[:, 1, :][dead] = 20.5
    st.stream[:1, 0, -1:][dead[:1, -1:]] = float("nan")
    got = sess.histogram(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert torch.equal(got, want) and int(got.sum()) == sess.n
    plain = render.histogram_xy(st.stream[:, 0, :], st.stream[:, 1, :], ~dead,
                                render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert torch.equal(plain, want)
    every = render.console_histogram(st.stream[:, 0, :], st.stream[:, 1, :], None,
                                     render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE)
    assert int(every.sum()) > sess.n  # the dead slots' xy, counted when every slot is live


def test_console_histogram_layouts_and_shift():
    """A [N, D] array is one row of N live slots; x_shift moves x before the
    bin, as the sharded stream's global x; the session's grid is reused."""
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.uniform(-8.0, 72.0, (3000, 3)).astype(np.float32))
    ones = torch.ones(3000, dtype=torch.bool)
    for viewport, console in VIEWS:
        want = render.histogram_xy(pos[:, 0], pos[:, 1], ones, viewport, console)
        assert torch.equal(render.histogram(pos, viewport, console), want)
        shifted = render.histogram_xy(pos[:, 0] + 5.0, pos[:, 1], ones, viewport, console)
        got = render.console_histogram(pos[:, 0], pos[:, 1], None, viewport, console, x_shift=5.0)
        assert torch.equal(got, shifted) and not torch.equal(got, want)
    sess = _stream_session(2, frames=1)
    first = sess.histogram(*VIEWS[0])
    assert sess.histogram(*VIEWS[0]) is first and sess.histogram(*VIEWS[1]) is not first
    with pytest.raises(ValueError, match="float32"):
        render.console_histogram(pos[:, 0].double(), pos[:, 1], None, *VIEWS[0])
