"""PyTorch port, the frame program on the CPU: the in-place stream frame
against a functional loop and JAX's ``frame_binned``, ``Session.compile_run``
/ ``run`` against the JAX session's fused program, ``restore`` into the
session's own buffers, and every backend's frame body free of host reads
(what a CUDA graph capture needs; the capture itself runs only on the card,
in ``chip_smoke.py``'s graph phase)."""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d as jdefault_2d
from fluid_tpu.config import default_3d as jdefault_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.ops import stream_transfer as jstx
from fluid_tpu.session import Session as JSession
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch import step as tstep
from fluid_tpu_torch.ops import pallas_kernels as pk
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as tstx
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.utils import graph

torch.set_num_threads(1)

STATE_KEYS = ("stream", "count", "tid", "flag", "nbr", "shell_drop", "need_peak", "rebins")
BACKENDS = ("stream", "pallas", "tiled", "sorted", "dense")
aten = torch.ops.aten


def _fast_case(dim=3, n=192, seed=1, world=12.0):
    """Fast particles in a small box (tests/test_torch_stream.py's re-bin
    case): the drift flag fires several times within 8 substeps."""
    rng = np.random.default_rng(seed)
    base = jdefault_2d() if dim == 2 else jdefault_3d()
    cfg = base.replace(boundary_clip=((0.0,) * dim, (world,) * dim), grid_res=16)
    pos = rng.uniform(world / 4, world - world / 3, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * 4.0).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    return cfg, pos, vel, C, make_domain(cfg, halo_cells=4)


def _dam_case(iterations=2, n=512, seed=0):
    """A 32x32 2D dam (the compact domain of tests/test_session.py) with
    fast random velocities, as numpy for both packages."""
    rng = np.random.default_rng(seed)
    cfg = jdefault_2d().replace(iterations=iterations, boundary_clip=((0.0, 0.0), (32.0, 32.0)),
                                grid_res=16)
    pos = rng.uniform(8.0, 24.0, (n, 2)).astype(np.float32)
    vel = (rng.normal(size=(n, 2)) * 20.0).astype(np.float32)
    return cfg, pos, vel, make_domain(cfg, halo_cells=4)


def _host_loop_frame(st, cfg, dom, spec, mp, ma, substeps, n):
    """The stream frame as a loop that reads ``needs_rebin`` on the host
    after every substep and rebinds the state to each re-bin's new
    tensors: the form the frame had before its re-bins ran in place over a
    state's own tensors."""
    tshape, nt = tstx._tile_geometry(dom, spec)
    stages = tstx.substep_stages(cfg, dom, spec, "cpu")
    params = tstx.collect_params(cfg, mp, ma, "cpu")
    dep1 = stages.dep1(st)
    for _ in range(substeps):
        dep1 = tstx._substep_core(st, dep1, stages, params)
        if bool(tstx.needs_rebin(st)):
            st2 = tstx._rebin_full(st, cfg, dom, spec, tshape, nt, n)
            st = dataclasses.replace(st2, shell_drop=torch.maximum(st.shell_drop, st2.shell_drop),
                                     need_peak=torch.maximum(st.need_peak, st2.need_peak),
                                     rebins=st.rebins + 1)
            dep1 = stages.dep1(st)
    return st


@functools.lru_cache(maxsize=None)
def _jax_frame(cfg, dom, js, substeps, n):
    return jax.jit(lambda s, mp, ma: jstx.frame_binned(s, cfg, dom, js, mp, ma, substeps, n=n))


@pytest.mark.parametrize("mouse", [None, (8.0, 8.0)], ids=["no-mouse", "mouse"])
def test_inplace_frame_equals_host_loop_and_jax_rebins(mouse):
    """8 substeps with forced re-bins: ``frame_inplace`` with the eager
    branch leaves the state bit-equal to the functional host loop, fires as
    many re-bins as JAX's ``frame_binned`` (interpret mode) on the same
    state, and ``frame_binned`` (a copy run in place) leaves its input
    as it was."""
    cfg, pos, vel, C, dom = _fast_case()
    substeps, n = 8, pos.shape[0]
    nt = math.prod(s // 4 for s in dom.shape)
    js = jstx.StreamSpec(tile=4, cap=128, halo=2, group=2, active=nt, interpret=True)
    ts = tstx.StreamSpec(active=js.A)
    mp, ma = tstep.no_mouse() if mouse is None else tstep.mouse(mouse)

    st0 = tstx.bin_particles(tstate.from_numpy(pos, vel, C, device="cpu"), dom, ts, dt=cfg.dt)
    want = _host_loop_frame(st0.clone(), cfg, dom, ts, mp, ma, substeps, n)
    got = st0.clone()
    tstx.frame_inplace(got, cfg, dom, ts, mp, ma, graph.eager_branch, substeps, n)
    for k in STATE_KEYS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    before = st0.clone()
    out = tstx.frame_binned(st0, cfg, dom, ts, mp, ma, substeps, n)
    assert all(torch.equal(getattr(out, k), getattr(got, k)) for k in STATE_KEYS)
    assert all(torch.equal(getattr(st0, k), getattr(before, k)) for k in STATE_KEYS)

    jmp, jma = jstep.no_mouse() if mouse is None else jstep.mouse(mouse)
    jst = jstx.bin_particles(JParticles.create(pos, vel=vel, C=C), dom, js, dt=cfg.dt)
    jst = _jax_frame(cfg, dom, js, substeps, n)(jst, jmp, jma)
    assert int(got.rebins[0]) == int(jst.rebins[0]) > 0
    assert int(got.count.sum()) == n


def test_session_compile_run_then_run_matches_jax_fused_run():
    """The port's ``compile_run(3); run(3)`` against ``fluid_tpu``'s, the
    JAX session's fused 3-frame program (tests/test_session.py): positions
    and velocities within 1e-4 (tests/test_torch_session.py's tolerance),
    the same re-bin count, and ``compile_run`` changes no state."""
    cfg, pos, vel, dom = _dam_case()
    ja = JSession(cfg, dom, JParticles.create(pos, vel=vel), backend="stream")
    ja.compile_run(3)
    ja.run(3)
    sess = Session(cfg, dom, tstate.from_numpy(pos, vel, device="cpu"), backend="stream",
                   device="cpu")
    before = sess.stream_state().clone()
    sess.compile_run(3)
    assert all(torch.equal(getattr(sess.stream_state(), k), getattr(before, k)) for k in STATE_KEYS)
    sess.run(3)
    got, want = sess.particles(), ja.particles()
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), atol=1e-4, rtol=0)
    assert sess.rebins() == ja.rebins() > 0
    assert sess.live_count() == 512


def _torch_session(backend, strict=True):
    cfg, pos, vel, dom = _dam_case()
    p = tstate.from_numpy(pos, 0.05 * vel, device="cpu")
    return Session(cfg, dom, p, backend=backend, device="cpu", strict=strict)


def _buffers(sess):
    st = sess.frame_graph.state
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("cap", [128, 256])
def test_session_frames_keep_dead_slots_zero(dim, cap):
    """Fast particles under the mouse, several stream Session frames with
    re-bins (the collect updating the session's stream in place): every
    slot past a tile's count, and its flag, stays zero, and the state is
    bit-equal to ``frame_binned``'s from the same start."""
    cfg, pos, vel, C, dom = _fast_case(dim)
    cfg = cfg.replace(iterations=4)
    spec = tstx.StreamSpec(cap=cap, active=math.prod(s // 4 for s in dom.shape))
    sess = Session(cfg, dom, tstate.from_numpy(pos, vel, C, device="cpu"), backend="stream",
                   spec=spec, device="cpu")
    want = sess.stream_state().clone()
    mice = [tstep.mouse((6.0, 6.0)), None, tstep.mouse((5.0, 7.0))]
    for mouse in mice:
        sess.frame(mouse)
        mp, ma = tstep.no_mouse() if mouse is None else mouse
        want = tstx.frame_binned(want, cfg, dom, spec, mp, ma, n=pos.shape[0])
    st = sess.stream_state()
    assert sess.rebins() > 0
    for k in STATE_KEYS:
        assert torch.equal(getattr(st, k), getattr(want, k)), k
    dead = torch.arange(cap)[None, :] >= st.count[:, None]
    assert int(st.stream.permute(0, 2, 1)[dead].count_nonzero()) == 0
    assert int(st.flag[dead].count_nonzero()) == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_keeps_the_buffers_and_replays(backend):
    """``restore`` copies into the session's buffers (every ``data_ptr``
    unchanged, as a captured graph needs) and the frames after it replay
    bit for bit, twice from one snapshot."""
    sess = _torch_session(backend)
    ptrs = {k: t.data_ptr() for k, t in _buffers(sess).items()}
    sess.frame(tstep.mouse((16.0, 16.0)))
    snap = sess.snapshot()
    sess.run(2)
    want = sess.particles()
    for _ in range(2):
        sess.restore(snap)
        assert {k: t.data_ptr() for k, t in _buffers(sess).items()} == ptrs
        sess.run(2)
        got = sess.particles()
        assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in tstate.FIELDS)


class HostRead(RuntimeError):
    pass


class NoHostRead(TorchDispatchMode):
    """Raises on what a CUDA graph capture cannot take: a read of a tensor's
    value on the host (``aten._local_scalar_dense``, which ``bool()``,
    ``int()`` and ``.item()`` call), an op whose output shape depends on the
    data (``nonzero``, ``masked_select``, ``unique``, ``repeat_interleave``,
    and indexing with a bool mask, which runs ``nonzero`` below this mode),
    and a tensor made from Python data (``aten.lift_fresh`` and its kin: on
    the card a copy from pageable host memory).  ``paused`` lets the kernel
    wrappers' plain versions through: on the card a wrapper launches its
    kernel instead."""

    RAISE = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten._unique2,
             aten.unique_consecutive, aten.unique_dim, aten.repeat_interleave,
             aten.lift_fresh, aten.lift_fresh_copy, aten.lift}
    INDEXING = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}

    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            packet = func.overloadpacket
            if packet in self.RAISE:
                raise HostRead(str(func))
            if packet in self.INDEXING and any(
                    t is not None and t.dtype == torch.bool for t in args[1]):
                raise HostRead(f"{func} with a bool mask")
        return func(*args, **(kwargs or {}))


class StateCopies(TorchDispatchMode):
    """Records each ``copy_`` into a tensor whose data starts at one of
    ``ptrs``, as ``outside`` or, within a ``paused`` call, ``inside``."""

    def __init__(self, ptrs):
        super().__init__()
        self.ptrs = ptrs
        self.paused = 0
        self.outside, self.inside = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is aten.copy_ and args[0].data_ptr() in self.ptrs:
            (self.inside if self.paused else self.outside).append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dim", [2, 3])
def test_frame_body_copies_no_stream_outside_the_rebin(dim):
    """The stream frame body, as a Session captures it, with every re-bin
    taken: outside the re-bin's body nothing copies into the state's
    stream or flag (the collect writes their live slots in place); the
    re-bin's own fill, which does, is seen."""
    cfg, pos, vel, C, dom = _fast_case(dim)
    sess = Session(cfg.replace(iterations=4), dom, tstate.from_numpy(pos, vel, C, device="cpu"),
                   backend="stream", device="cpu", strict=False)
    fg = sess.frame_graph
    scratch = fg.state.clone()
    mode = StateCopies({scratch.stream.data_ptr(), scratch.flag.data_ptr()})
    with mode:
        fg.body(scratch, lambda pred, fn: _paused(mode, fn)())
    assert mode.outside == []
    assert len(mode.inside) >= 4 and int(scratch.rebins[0]) == 4


@pytest.mark.parametrize("what", ["as_tensor(list)", "tensor(numpy)", "bool()", "item()",
                                  "nonzero", "mask index"])
def test_no_host_read_mode_catches(what):
    """The mode below sees each host read a capture would fail on."""
    x = torch.arange(4.0)
    calls = {
        "as_tensor(list)": lambda: torch.as_tensor([1.0, 2.0]),
        "tensor(numpy)": lambda: torch.tensor(np.arange(3)),
        "bool()": lambda: bool(x.sum() > 0),
        "item()": lambda: x.max().item(),
        "nonzero": lambda: x.nonzero(),
        "mask index": lambda: x[x > 1.0],
    }
    with pytest.raises(HostRead), NoHostRead():
        calls[what]()


def _paused(mode, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        mode.paused += 1
        try:
            return fn(*args, **kwargs)
        finally:
            mode.paused -= 1
    return run


@pytest.mark.parametrize("backend", BACKENDS)
def test_frame_body_makes_no_host_read(backend, monkeypatch):
    """Each backend's frame body, as a Session captures it, run on a scratch
    copy of the state with ``warm_branch`` (the re-bin taken without reading
    its flag) after one warm run that makes the device constants, as the
    warm-up before a capture does: no host read, no data-dependent shape,
    no tensor from Python data."""
    sess = _torch_session(backend, strict=False)
    fg = sess.frame_graph
    fg.body(fg.state.clone(), graph.warm_branch)
    mode = NoHostRead()
    for mod, names in ((sk, ("deposit_p2g1_plain", "deposit_p2g2_plain", "collect_plain",
                             "halo_axes_plain", "halo_gblk_plain", "rebin_gather_plain",
                             "rebin_fill_plain")),
                       (pk, ("deposit_plain", "p2g2_plain", "collect_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, _paused(mode, getattr(mod, name)))
    scratch = fg.state.clone()
    with mode:
        fg.body(scratch, graph.warm_branch)
    if backend == "stream":
        assert int(scratch.rebins[0]) == sess.cfg.iterations  # every re-bin body ran
