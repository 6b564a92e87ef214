"""PyTorch port, the recorder (``fluid_tpu_torch/utils/timing.py``) on the CPU:
the ``Session``'s host spans, the span ring, the off switch, the clock fit,
the split of the device's idle time by host span, and the benchmark's
readers of the recorder (``bench_torch/metrics``) on synthetic records.
The device stamps themselves run only on the card (``chip_smoke.py``'s
trace phase)."""

import importlib.util
import sys
import tracemalloc
import types
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from fluid_tpu_torch import render, scene
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.utils import timing

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def sess():
    """A strict stream Session of a small 2D dam on the CPU, one frame in."""
    cfg, p, dom = scene.reference_scene_2d(n=256, device="cpu")
    s = Session(cfg, dom, p, backend="stream", device="cpu")
    s.frame()
    return s


def _spans_of(call) -> list:
    """(name, depth, start, end) of the spans ``call()`` recorded."""
    t0 = timing.time.perf_counter_ns()
    call()
    t1 = timing.time.perf_counter_ns()
    return [s for s in timing.recorder().records(t0, t1).spans if s[2] >= t0 and s[3] <= t1]


CALLS = {
    "frame": (lambda s: s.frame(), [("frame", 0), ("mouse", 1), ("replay", 1), ("check", 1)]),
    "run": (lambda s: s.run(2), [("run", 0), ("mouse", 1), ("replay", 1), ("replay", 1),
                                 ("check", 1)]),
    "render": (lambda s: s.render(render.DEFAULT_VIEWPORT, render.DEFAULT_CONSOLE),
               [("render", 0), ("histogram", 1), ("read", 1), ("ascii", 1)]),
    "restore": (lambda s: s.restore(s.snapshot()), [("snapshot", 0), ("restore", 0)]),
    "particles": (lambda s: s.particles(), [("particles", 0)]),
    "block_until_ready": (lambda s: s.block_until_ready(), [("sync", 0)]),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_session_spans_nest_and_close_in_order(sess, call):
    """Each call's spans, by name and depth, in order; each inside its
    parent, and spans of one depth one after another."""
    fn, want = CALLS[call]
    got = _spans_of(lambda: fn(sess))
    assert [(n, d) for n, d, _, _ in got] == want
    for k, (name, depth, a, b) in enumerate(got):
        assert a <= b
        if depth:
            parent = [s for s in got[:k] if s[1] == depth - 1][-1]
            assert parent[2] <= a and b <= parent[3], (name, parent)
        before = [s for s in got[:k] if s[1] == depth]
        assert not before or before[-1][3] <= a, (name, before[-1])


def test_full_ring_drops_the_oldest_and_counts_them():
    rec = timing.Recorder(spans=8)
    for k in range(12):
        rec.record(f"s{k}", 100 * k, 100 * k + 50)
    got = rec.records()
    assert [n for n, _, _, _ in got.spans] == [f"s{k}" for k in range(4, 12)]
    assert got.dropped == rec.dropped == 4
    with rec.span("last"):
        pass
    assert rec.records().spans[-1][0] == "last" and rec.dropped == 5


def test_a_window_older_than_the_full_ring_reads_as_lost():
    """A window that starts before the oldest span (or counter sample) a
    full ring holds reads as lost, and ``gap_after`` finds nothing there:
    the first two spans of a name the ring holds need not be the first two
    after the window's start."""
    rec = timing.Recorder(spans=8)
    for k in range(12):  # 0-3 dropped (the last ends at 350), 4-11 held
        rec.record("particles" if k in (1, 2, 9, 10) else "frame", 100 * k, 100 * k + 50)
    assert rec.records(0, 2000).lost and rec.records(449, 2000).lost
    assert not rec.records(450, 2000).lost and not rec.records(450).lost
    assert rec.gap_after("particles", 0) is None
    assert rec.gap_after("particles", 500) == (950, 1000)
    rec = timing.Recorder(spans=8)
    rec._counts = deque(maxlen=4)
    for k in range(6):  # samples at 0 and 100 dropped
        rec.count("fill_peak", k, 8, at=100 * k)
    assert rec.records(0, 600).lost and rec.records(200, 600).lost
    got = rec.records(201, 600)
    assert not got.lost and [c[2] for c in got.counts] == [3, 4, 5]
    assert not timing.Recorder().records().lost


def test_tracing_off_records_nothing_and_allocates_nothing(sess):
    rec = timing.Recorder(on=False)
    assert rec.span("mouse") is rec.span("replay") is timing._NOOP
    assert rec.ring(torch.device("cpu")) is None
    for _ in range(10):  # warm: the loop's own objects exist first
        with rec.span("mouse"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with rec.span("mouse"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename == timing.__file__]
    assert not grown, grown
    assert rec.records().spans == [] and rec.dropped == 0
    timing.tracing(False)
    try:
        assert _spans_of(lambda: sess.frame()) == []
    finally:
        timing.tracing(True)
    assert [n for n, *_ in _spans_of(lambda: sess.block_until_ready())] == ["sync"]


@pytest.mark.parametrize("jitter", [0, 300])
def test_clock_fit_recovers_offset_and_drift(jitter):
    """Device ns 1.7e18 from the epoch, host ns 4e12 from boot, the device
    clock 20 ppm fast, anchors 10 s apart: the fit maps a stamp between
    them within the anchors' jitter and reports it as its residual."""
    rng = np.random.default_rng(0)
    d = 1_700_000_000_000_000_000 + np.arange(12, dtype=np.int64) * 10_000_000_000
    host = lambda t: 4_000_000_000_000 + 123_456 + (t - d[0]) / 1.00002  # noqa: E731
    h = [int(host(t) + rng.integers(-jitter, jitter + 1)) for t in d]
    to_host, residual = timing.fit_clock(list(zip(d.tolist(), h)))
    probe = int(d[0] + 55_555_555_555)
    assert abs(float(to_host(probe)) - host(probe)) <= max(2 * jitter, 2)
    assert (residual <= 2) if jitter == 0 else (jitter / 4 <= residual <= 2 * jitter)
    one, res = timing.fit_clock([(int(d[0]), h[0])])
    assert float(one(int(d[0]) + 1000)) == h[0] + 1000 and res == 0.0


def test_pairs_drop_cut_and_unmatched_stamps():
    T = timing
    tags = np.array([T.FRAME_END, T.FRAME_BEGIN, T.REBIN_BEGIN, T.REBIN_END, T.FRAME_END,
                     T.FRAME_BEGIN, T.REBIN_BEGIN])
    times = np.arange(len(tags), dtype=np.int64) * 10
    assert [x.tolist() for x in T.pair_stamps(tags, times, T.FRAME_BEGIN, T.FRAME_END)] == [[10], [40]]
    assert [x.tolist() for x in T.pair_stamps(tags, times, T.REBIN_BEGIN, T.REBIN_END)] == [[20], [30]]


def _app_frame(rec, base: int) -> None:
    """One app frame of host spans from ``base`` (ns), as the Session
    records them: render, frame (mouse, replay, check), sync; then 30 ns
    between calls."""
    for name, a, b, kids in (
            ("render", 0, 100, (("histogram", 0, 10), ("read", 10, 60), ("ascii", 60, 100))),
            ("frame", 100, 400, (("mouse", 100, 110), ("replay", 110, 130), ("check", 130, 400))),
            ("sync", 400, 420, ())):
        rec._open.append(base + a)
        for kid, c, d in kids:
            rec.record(kid, base + c, base + d)
        rec._open.pop()
        rec.record(name, base + a, base + b)


# the device runs each frame graph over [125, 380] of its app frame
SPLIT = {"render/histogram": 10, "render/read": 50, "render/ascii": 40, "frame/mouse": 10,
         "frame/replay": 15, "frame/check": 20, "sync": 20, timing.BETWEEN: 30}


# device spans in the traced stretch [0.5 s, 1.0 s) of a batch run: a frame
# and two re-bins in it, a re-bin that crosses its end
STRETCH = [("frame", 550e6, 560e6), ("rebin", 600e6, 601e6), ("rebin", 700e6, 700.5e6),
           ("rebin", 900e6, 1100e6)]


# fill_peak samples (time, value) of the strict checks, cap 128: two in the
# traced stretch, the fuller ones outside it
FILLS = [(400_000_000, 300), (600_000_000, 90), (800_000_000, 100), (1_100_000_000, 200)]
# occupied samples (time, value) of the same checks, A 1,000: two in the
# traced stretch
OCCUPIED = [(450_000_000, 900), (700_000_000, 200), (950_000_000, 300), (1_050_000_000, 1000)]


def _synthetic(monkeypatch, frames=2, base=1_200_000_000, period=450):
    """A recorder holding ``frames`` app frames after a ``particles`` span,
    and the next ``particles`` span; its device records synthetic: the app
    frames' and ``STRETCH``."""
    rec = timing.Recorder()
    rec.record("particles", base - 100, base)
    for k in range(frames):
        _app_frame(rec, base + k * period)
    rec.record("particles", base + frames * period, base + frames * period + 50)
    for at, fill in FILLS:
        rec.count("fill_peak", fill, 128, at=at)
    for at, occupied in OCCUPIED:
        rec.count("occupied", occupied, 1000, at=at)
    device = STRETCH + [("frame", float(base + k * period + 125), float(base + k * period + 380))
                        for k in range(frames)]

    def device_records(t0, t1):
        return ([s for s in device if s[1] < t1 and s[2] > t0], len(device) * 2, 0, 0.0, 2, 0.0)

    monkeypatch.setattr(rec, "_device_records", device_records)
    monkeypatch.setattr(timing, "_RECORDER", rec)
    return rec


def test_idle_by_span_splits_the_gaps_by_innermost_span(monkeypatch):
    """Idle is [0, 125) and [380, 450) of each app frame: the check is
    charged only after the frame ends, the replay only before it starts,
    the time after sync to between calls."""
    rec = _synthetic(monkeypatch)
    base = 1_200_000_000
    got = rec.idle_by_span(base, base + 900)
    assert set(got) == set(SPLIT)
    for k, v in SPLIT.items():
        assert got[k] == pytest.approx(2 * v * 1e-9, abs=1e-15), k
    assert sum(got.values()) == pytest.approx(900e-9 - 2 * 255e-9)
    assert timing.idle_under(got, "render") == pytest.approx(200e-9)
    # one frame over the whole window, nothing idle; a window before any span
    assert timing.split_idle([], [("frame", 0, 10)], 2, 8) == {}
    assert timing.split_idle([], [], 0, 10) == {timing.BETWEEN: pytest.approx(1e-8)}
    assert rec.gap_after("particles", base - 1000) == (base, base + 900)


def _metric(name: str):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  REPO / "bench_torch" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# the traced stretch is [0.5 s, 1.0 s); the untraced tail after it the two
# app frames of ``_synthetic``
WANT = {
    "graph_idle.interactive": 2 * 195 / 900 * 100.0,
    "render_idle_ms.interactive": 100e-6,
    "session_idle_ms.interactive": 65e-6,
    "frame_device_ms.interactive": 255e-6,
    "rebin_device_ms.batch": (1_000_000 + 500_000) / 3 * 1e-6,
    "tile_fill_peak.interactive": 100 / 128 * 100.0,
    "occupied_share.batch": (200 + 300) / 2 / 1000 * 100.0,
}


@pytest.mark.parametrize("name", list(WANT))
def test_metric_reads_a_synthetic_run_and_none_without_stamps(monkeypatch, name):
    run = types.SimpleNamespace(stretch=types.SimpleNamespace(_t0=0.5, _t1=1.0), traced_frames=3)
    _synthetic(monkeypatch)
    assert _metric(name)(run) == pytest.approx(WANT[name], rel=1e-9)
    monkeypatch.setattr(timing, "_RECORDER", timing.Recorder())
    assert _metric(name)(run) is None
    # a program without the recorder (the parent of the benchmark's new metrics)
    monkeypatch.setitem(sys.modules, "fluid_tpu_torch.utils.timing", types.ModuleType("timing"))
    assert _metric(name)(run) is None
