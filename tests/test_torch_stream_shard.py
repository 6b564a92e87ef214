"""PyTorch port, the sharded stream backend against ``fluid_tpu``: per-shard
binning is bit-identical to JAX's ``shard_stream``, the ghost-gated halos
equal JAX's ghost-aware ones, one sharded substep from a JAX state matches
JAX's, and a re-binning, migrating frame matches JAX dense.  The port's
shards are CPU devices (``["cpu"] * s``) and its kernels run as their plain
versions; JAX runs on the 8 virtual CPU devices of ``conftest.py``, its
kernels in interpret mode."""

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fluid_tpu import render as jrender
from fluid_tpu import step as jstep
from fluid_tpu.config import default_2d, default_3d
from fluid_tpu.domain import make_domain
from fluid_tpu.ops import stream_transfer as jstx
from fluid_tpu.parallel import stream_shard as jsh
from fluid_tpu.state import ParticleState as JParticles
from fluid_tpu_torch import app, step
from fluid_tpu_torch import state as tstate
from fluid_tpu_torch.ops import stream_kernels as sk
from fluid_tpu_torch.ops import stream_transfer as tstx
from fluid_tpu_torch.parallel import stream_shard as tsh

torch.set_num_threads(1)

ST_KEYS = ("stream", "count", "tid", "flag", "nbr", "shell_drop", "need_peak", "rebins")


def _case(dim, n, seed, vel_scale=3.0, world=16.0):
    """tests/test_stream_shard.py::_case at world 16, seeded with numpy."""
    rng = np.random.default_rng(seed)
    base = default_2d() if dim == 2 else default_3d()
    cfg = base.replace(boundary_clip=((0.0,) * dim, (world,) * dim), grid_res=16)
    pos = rng.uniform(world / 4, world - world / 4, (n, dim)).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * vel_scale).astype(np.float32)
    C = (rng.normal(size=(n, dim, dim)) * 0.05).astype(np.float32)
    return cfg, make_domain(cfg, halo_cells=4), pos, vel, C


def _mesh(s):
    return Mesh(np.array(jax.devices()[:s]), (jsh.AXIS,))


def _port_spec(js):
    """The port's spec with the JAX spec's geometry and budget."""
    return tsh.StreamShardSpec(
        domain=js.domain, n_shards=js.n_shards, ts=js.ts,
        spec=tstx.StreamSpec(active=js.spec.A), migrate_cap=js.migrate_cap,
        live_cap=js.live_cap)


def _jax_numpy(ss):
    """A JAX ShardStreamState as the numpy dict
    ``shard_stream_state_from_numpy`` takes."""
    d = {k: np.asarray(getattr(ss.st, k)) for k in ST_KEYS}
    d["col"] = np.asarray(ss.col)
    return d


def _both_binned(dim, s, n=256, seed=0, **kw):
    cfg, dom, pos, vel, C = _case(dim, n, seed, **kw)
    js = jsh.default_shard_spec(cfg, dom, s, n)
    ts = _port_spec(js)
    jss = jsh.shard_stream(JParticles.create(pos, vel=vel, C=C), cfg, js, _mesh(s))
    tss = tsh.shard_stream(tstate.from_numpy(pos, vel, C, device="cpu"), cfg, ts, ["cpu"] * s)
    return cfg, dom, js, ts, jss, tss, (pos, vel, C)


@pytest.mark.parametrize("dim,s", [(2, 2), (2, 4), (3, 2), (3, 4)])
def test_shard_binning_equals_jax(dim, s):
    """Each shard's count, tid, nbr, col, stream, flag and watermarks are
    JAX's bit for bit, and the gate rebuilds JAX's ghost-aware tables."""
    cfg, dom, js, ts, jss, tss, _ = _both_binned(dim, s)
    want = tsh.shard_stream_state_from_numpy(_jax_numpy(jss), ts, ["cpu"] * s)
    nbrg = np.split(np.asarray(jss.st.nbrg), s)
    for k, (got, ref) in enumerate(zip(tss, want)):
        for key in ST_KEYS:
            assert torch.equal(getattr(got.st, key), getattr(ref.st, key)), (k, key)
        assert torch.equal(got.col, ref.col) and torch.equal(got.gate, ref.gate), k
        gated = jstx._gated_nbr(jnp.asarray(got.st.nbr.numpy()), jnp.asarray(got.gate.numpy()),
                                ts.spec.A, dim)
        np.testing.assert_array_equal(np.asarray(gated), nbrg[k])
    ghosts = [int((ss.gate - ss.st.count).sum()) for ss in tss]
    assert all(g == 2 * ts.ncol for g in ghosts), ghosts  # both ghost columns active


@pytest.mark.parametrize("dim", [2, 3])
def test_bin_rows_occ_force_equals_jax(dim):
    """``_bin_rows(occ_force=...)``: forced tiles join the relay closure and
    bin as zero-count actives, exactly as in JAX."""
    rng = np.random.default_rng(dim)
    tshape = (6, 5) if dim == 2 else (5, 4, 6)
    nt = math.prod(tshape)
    n, F = 300, 2 * dim + dim * dim + 4
    rows = rng.normal(size=(n, F)).astype(np.float32)
    keys = rng.integers(0, nt + 1, n)  # nt: a row that lands nowhere
    keys[keys > nt // 2] = nt  # half the grid empty
    force = rng.random(nt) < 0.1
    js = jstx.StreamSpec(tile=4, cap=128, halo=2, group=2, active=nt, interpret=True)
    spec = tstx.StreamSpec(active=js.A)
    want = jstx._bin_rows(jnp.asarray(rows), jnp.asarray(keys, jnp.int32), n, js, nt, tshape,
                          occ_force=jnp.asarray(force))
    got = tstx._bin_rows(torch.as_tensor(rows), torch.as_tensor(keys), spec, nt, tshape,
                         occ_force=torch.as_tensor(force))
    ref = tstx.stream_state_from_numpy({k: np.asarray(getattr(want, k)) for k in ST_KEYS}, spec)
    for key in ST_KEYS:
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    plain = tstx._bin_rows(torch.as_tensor(rows), torch.as_tensor(keys), spec, nt, tshape)
    assert int(got.need_peak[0]) > int(plain.need_peak[0])


@pytest.mark.parametrize("dim", [2, 3])
def test_gated_halos_equal_jax(dim):
    """The plain halos gated on count + ghost equal JAX's halo over the
    ghost-aware tables on the same windows; with no gate they are the
    count-gated halo, as before."""
    cfg, dom, js, ts, jss, tss, _ = _both_binned(dim, 2)
    ss = tss[1]
    g = tstx.tile_geom(ts.local_domain, ts.spec)
    A, T, E = ts.spec.A, g.tile, g.E
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(A, dim, g.ncell)).astype(np.float32))
    nbrg = jnp.asarray(np.split(np.asarray(jss.st.nbrg), 2)[1])
    for gate in (ss.gate, ss.st.count):
        xin = jnp.asarray(torch.where((gate > 0)[:, None, None], x, 0.0).numpy())
        tables = nbrg if gate is ss.gate else jstx._gated_nbr(
            jnp.asarray(ss.st.nbr.numpy()), jnp.asarray(ss.st.count.numpy()), A, dim)
        want = np.asarray(jstx.halo_pull(xin.reshape(A, -1), tables, g.tshape, T, E)).reshape(x.shape)
        kw = {} if gate is ss.st.count else {"gate": gate}
        got = sk.halo_axes(x, ss.st.count, ss.st.nbr, g, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        m = torch.as_tensor(np.abs(rng.normal(size=(A, 1, g.ncell))).astype(np.float32))
        dtg = sk.gravity_step(cfg.dt, cfg.gravity)
        gb = sk.halo_gblk(x, m, ss.st.count, ss.st.nbr, dtg, g, **kw)
        v = torch.as_tensor(want) / m + torch.as_tensor(dtg)[None, :, None]
        on = (gate > 0)[:, None, None]
        assert torch.equal(gb[:, dim:], torch.where(on, m, 0.0))
        torch.testing.assert_close(gb[:, :dim], torch.where(on, v, 0.0), rtol=1e-6, atol=0)
    assert not torch.equal(ss.gate, ss.st.count)


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_substep_launches_over_every_entry(dim, monkeypatch):
    """The sharded path passes no ``occupied`` to the kernels: its ghost
    entries hold no particle and lie past the binning's count, but the
    halos read the windows the exchange fills there, so every launch covers
    all A entries, and a count-0 entry's deposit and grid windows are zeros,
    as before the count bounded the frame's launches."""
    cfg, dom, js, ts, jss, tss, _ = _both_binned(dim, 2)
    past = [bool(((ss.gate > ss.st.count) & (torch.arange(ts.spec.A) >= ss.st.occupied)).any())
            for ss in tss]
    assert all(past)  # the ghost entries the halos gate on lie past the count
    calls = []

    def wrap(name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            win = out[2] if isinstance(out, tuple) else out
            # a deposit's or collect's first argument is its shard's count
            zero = (name in ("deposit_p2g1", "deposit_p2g2", "collect")
                    and not bool(win[args[0] == 0].any()))
            calls.append((name, kw.get("occupied"), bool(torch.isfinite(win).all()), zero))
            return out
        return call

    for name in ("deposit_p2g1", "deposit_p2g2", "collect", "halo_axes", "halo_gblk"):
        monkeypatch.setattr(sk, name, wrap(name, getattr(sk, name)))
    tsh.sharded_frame_binned(tss, cfg, ts, *step.no_mouse(), substeps=1)
    assert {c[0] for c in calls} == {"deposit_p2g1", "deposit_p2g2", "collect", "halo_axes",
                                     "halo_gblk"}
    for name, occupied, finite, zero in calls:
        assert occupied is None and finite, name
        assert zero or name.startswith("halo"), name


@pytest.fixture(scope="module")
def frame_case():
    """The 8-substep frame of tests/test_stream_shard.py (3D, world 16,
    256 particles, fast random velocities) and its JAX dense result."""
    cfg, dom, pos, vel, C = _case(3, 256, seed=5)
    mp, ma = jstep.no_mouse()
    want = jax.jit(lambda q: jax.lax.fori_loop(
        0, 8, lambda _, s: jstep.substep(s, cfg, dom, mp, ma)[0], q))(
        JParticles.create(pos, vel=vel, C=C))
    return cfg, dom, (pos, vel, C), want


def _port_frame(cfg, dom, arrays, s, substeps=8):
    p = tstate.from_numpy(*arrays, device="cpu")
    sspec = tsh.default_shard_spec(cfg, dom, s, p.n, pos=p.pos, vel=p.vel)
    states = tsh.shard_stream(p, cfg, sspec, ["cpu"] * s)
    states, rebins = tsh.sharded_frame_binned(states, cfg, sspec, *step.no_mouse(), substeps=substeps)
    return tsh.gather_stream(states, cfg, sspec, p.n), rebins, states


def test_one_sharded_substep_matches_jax():
    """From the same binned state (JAX's, loaded with
    ``shard_stream_state_from_numpy``), one substep of the port's sharded
    frame matches JAX's ``sharded_stream_frame(substeps=1)``."""
    s = 2
    cfg, dom, js, ts, jss, _, _ = _both_binned(3, s, n=256, seed=2)
    states = tsh.shard_stream_state_from_numpy(_jax_numpy(jss), ts, ["cpu"] * s)
    jout, jrb = jsh.sharded_stream_frame(jss, cfg, js, _mesh(s), *jstep.no_mouse(), substeps=1)
    want = jsh.gather_stream(jout, cfg, js, 256)
    out, rebins = tsh.sharded_frame_binned(states, cfg, ts, *step.no_mouse(), substeps=1)
    got = tsh.gather_stream(out, cfg, ts, 256)
    assert rebins == int(jrb)
    for name in ("pos", "vel", "C"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-5, rtol=0, err_msg=name)
    for name in ("density", "pressure"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_sharded_frame_matches_jax_dense(frame_case):
    """8 substeps at s = 4 with re-bins and migration: within 1e-3 of JAX
    dense, with the re-bin count of JAX's sharded run."""
    cfg, dom, arrays, want = frame_case
    s = 4
    got, rebins, states = _port_frame(cfg, dom, arrays, s)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-3, rtol=0, err_msg=name)
    js = jsh.default_shard_spec(cfg, dom, s, 256, pos=jnp.asarray(arrays[0]), vel=jnp.asarray(arrays[1]))
    jss = jsh.shard_stream(JParticles.create(*arrays), cfg, js, _mesh(s))
    _, jrb = jsh.sharded_stream_frame(jss, cfg, js, _mesh(s), *jstep.no_mouse(), substeps=8)
    assert rebins == int(jrb) >= 1
    assert sum(int(ss.migrated[0]) for ss in states) > 0


def test_ghost_gate_carries_the_boundary(frame_case, monkeypatch):
    """Without ghost columns (the mask patched to all-False: no forced
    relays, halos gated on count alone) flow across the slab boundary is
    lost and the frame leaves dense by more than 1e-3; with them it
    matches."""
    cfg, dom, arrays, want = frame_case
    got, _, _ = _port_frame(cfg, dom, arrays, 2)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-3, rtol=0)
    monkeypatch.setattr(tsh, "_ghost_mask", lambda sspec, device: torch.zeros(
        math.prod(tsh._local_tshape(sspec)), dtype=torch.bool, device=device))
    lost, _, _ = _port_frame(cfg, dom, arrays, 2)
    assert float(np.abs(lost.pos.numpy() - np.asarray(want.pos)).max()) > 1e-3


@pytest.mark.parametrize("dim,substeps", [(2, 20), (3, 10)])
def test_migration_moves_particles(dim, substeps):
    """Particles moving +x change owners in a frame and stay within 1e-3 of
    JAX dense (tests/test_stream_shard.py:172; 2D's dt is half 3D's)."""
    cfg, dom, pos, _, C = _case(dim, 256, seed=1, vel_scale=0.0)
    vel = np.zeros_like(pos)
    vel[:, 0] = 6.0
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    sspec = tsh.default_shard_spec(cfg, dom, 2, p.n)
    states = tsh.shard_stream(p, cfg, sspec, ["cpu", "cpu"])
    before = [int(ss.st.count.sum()) for ss in states]
    states, _ = tsh.sharded_frame_binned(states, cfg, sspec, *step.no_mouse(), substeps=substeps)
    after = [int(ss.st.count.sum()) for ss in states]
    assert sum(after) == p.n and after[1] > before[1]
    got = tsh.gather_stream(states, cfg, sspec, p.n)
    mp, ma = jstep.no_mouse()
    want = jax.jit(lambda q: jax.lax.fori_loop(
        0, substeps, lambda _, s: jstep.substep(s, cfg, dom, mp, ma)[0], q))(
        JParticles.create(pos, vel=vel, C=C))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), atol=1e-3, rtol=0)


def test_budget_exhaustion_fails_loudly():
    """A per-shard budget far below a slab's closure fails at binning or in
    ``gather_stream`` (tests/test_stream_shard.py:145)."""
    import dataclasses

    cfg, dom, pos, vel, C = _case(3, 512, seed=6, vel_scale=0.0)
    sspec = tsh.default_shard_spec(cfg, dom, 2, 512)
    sspec = dataclasses.replace(sspec, spec=dataclasses.replace(sspec.spec, active=8))
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    try:
        states = tsh.shard_stream(p, cfg, sspec, ["cpu", "cpu"])
    except ValueError:
        return
    assert max(int(ss.st.shell_drop[0]) for ss in states) > 0
    with pytest.raises(RuntimeError):
        tsh.gather_stream(states, cfg, sspec, 512)


@pytest.mark.parametrize("cut", ["migrate_cap", "live_cap"])
def test_rebin_drops_count_into_shell_drop(cut):
    """The two silent losses of the JAX re-bin fail loudly here: movers
    past ``migrate_cap`` (they would bin in a ghost tile, whose window the
    exchange overwrites) and live rows past ``live_cap`` count into
    ``shell_drop``, and a strict session raises."""
    import dataclasses

    cfg, dom, pos, _, C = _case(3, 256, seed=1, vel_scale=0.0)
    vel = np.zeros_like(pos)
    vel[:, 0] = 6.0
    p = tstate.from_numpy(pos, vel, C, device="cpu")
    sspec = tsh.default_shard_spec(cfg, dom, 2, p.n)
    sspec = dataclasses.replace(sspec, **{cut: 1 if cut == "migrate_cap" else 64})
    sess = tsh.ShardedSession(cfg.replace(iterations=10), dom, p, devices=["cpu", "cpu"],
                              sspec=sspec)
    with pytest.raises(RuntimeError, match="budget exhaustion"):
        sess.frame()
    assert sess.shell_drop() > 0


def test_sharded_session():
    """ShardedSession: frames, strict checks, render equal to JAX's render
    of the same particles, snapshot/restore replay bit-identical
    (tests/test_stream_shard.py:194)."""
    cfg, dom, pos, vel, C = _case(3, 192, seed=3)
    cfg = cfg.replace(iterations=3)
    sess = tsh.ShardedSession(cfg, dom, tstate.from_numpy(pos, vel, C, device="cpu"),
                              devices=["cpu", "cpu"])
    for _ in range(2):
        sess.frame()
    sess.block_until_ready()
    lines = sess.render((16.0, 16.0), (20, 10))
    out = sess.particles()
    want = jrender.ascii_frame(np.asarray(jrender.histogram(jnp.asarray(out.pos.numpy()),
                                                            jnp.asarray((16.0, 16.0)), (20, 10))))
    assert lines == want and any(c != " " for ln in lines for c in ln)
    assert out.pos.shape == (192, 3) and bool(torch.isfinite(out.pos).all())
    snap = sess.snapshot()
    sess.run(1)
    first, f1, r1 = [ss.clone() for ss in sess.shard_states()], sess._frames, sess.rebins
    sess.restore(snap)
    sess.run(1)
    assert sess._frames == f1 and sess.rebins == r1
    for a, b in zip(first, sess.shard_states()):
        for key in ST_KEYS:
            assert torch.equal(getattr(a.st, key), getattr(b.st, key)), key
        assert torch.equal(a.col, b.col) and torch.equal(a.gate, b.gate)
    assert sess.live_count() == 192 and sess.shell_drop() == 0 and sess.need_peak() > 0


def test_default_shard_spec_equals_jax():
    """The budget formula and the probed slab closure agree with JAX's."""
    cfg, dom, pos, vel, _ = _case(3, 256, seed=0)
    for s in (2, 4):
        js = jsh.default_shard_spec(cfg, dom, s, 256)
        ts = tsh.default_shard_spec(cfg, dom, s, 256)
        assert (ts.ts, ts.migrate_cap, ts.live_cap, ts.spec.active) == (
            js.ts, js.migrate_cap, js.live_cap, js.spec.active)
        assert tsh._probe_slab_peak(cfg, dom, s, ts.ts, torch.as_tensor(pos), torch.as_tensor(vel)) \
            == jsh._probe_slab_peak(cfg, dom, s, js.ts, jnp.asarray(pos), jnp.asarray(vel))


def test_sharded_session_defaults_to_the_card():
    """No devices given: the cards, never the CPU; raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, dom, pos, vel, C = _case(3, 64, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.ShardedSession(cfg, dom, tstate.from_numpy(pos, vel, C, device="cpu"))


def test_app_cpu_shards_headless(capsys):
    """``app --cpu --shards 2 --headless``: sharded frames with renders."""
    app.main(["--cpu", "--shards", "2", "--dim", "2", "--particles", "256", "--frames", "2",
              "--headless"])
    text = capsys.readouterr().out
    assert "--- frame 1 ---" in text and text.count("frame: ") == 2
    block = text.split("--- frame 1 ---\n")[1].splitlines()[:40]
    assert len(block) == 40 and any(c in "".join(block) for c in ".-=*%$#")


@pytest.mark.parametrize("argv", [["--cpu", "--shards", "2", "--timing"], ["--shards", "2"]],
                         ids=["timing", "no-card"])
def test_app_shards_refusals(argv):
    """``--timing --shards`` stays refused; without ``--cpu`` the shards
    need as many cards."""
    if "--cpu" not in argv and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    with pytest.raises(SystemExit) as e:
        app.main([*argv, "--frames", "1", "--headless"])
    assert e.value.code not in (0, None)


def test_app_run_shards_on_cpu():
    """``app.run(shards=...)`` on a CPU device gives CPU shards."""
    out = io.StringIO()
    app.run(dim=3, n=128, frames=1, headless=True, out=out, device="cpu", shards=2)
    assert "--- frame 0 ---" in out.getvalue()
