"""Timing: the per-phase timer and the recorder of host spans and device stamps.

``PhaseTimer`` (the port of ``fluid_tpu/utils/timing.py``) times each phase
of a substep and shows the last substep's times under the render
(``2d_multi.rs:112-132,479-487``): it runs a frame phase by phase with those
labels (``clear`` is gone: the deposits start from zeros); a backend without
separate phases ("pallas") is timed a whole substep at a time, under
``substep``.  On a CUDA device a phase is timed with CUDA events around it;
on the CPU with the host clock.  Either way one element of the phase's
result is read afterwards, so a device fault shows up at the phase that
caused it.

The recorder (``recorder()``, one a process, on by default) keeps what the
program itself does, on one clock:

* host spans, ``with span(name):`` around the ``Session``'s calls and their
  parts and the frame graph's capture, timed by ``time.perf_counter_ns``
  and written when they close into preallocated ring arrays (name, depth,
  start, end); a full ring drops its oldest records and counts them, and
  a window that starts before the oldest it holds reads as lost;
* device stamps, (tag, ``%globaltimer``) written on the card by a one-thread
  kernel of ``csrc/graph_if.cu`` into a ring of the recorder's on that
  device: the frame graph captures one as its first and one as its last
  node (``frame_begin``, ``frame_end``) and one each side of every IF body
  (``rebin_begin``, ``rebin_end``), so each replay and each re-bin that
  fires stamps itself;
* counter samples, ``count(name, value, limit)``: a value the program has
  read anyway (the strict check's read of the stream's ``fill_peak``
  watermark beside its cap), stamped with the host clock into a ring of its
  own;
* anchors, an eager stamp between two synchronizes timed on the host clock
  (the tightest of a few), taken when a device's ring is made and at each
  read; a linear fit of the anchors maps the device's clock onto the
  host's (the two drift apart by milliseconds over minutes).

``records(t0, t1)`` gives a window's host spans, device spans (``frame``
and ``rebin``, begin to end) and counter samples on the host clock;
``idle_by_span(t0, t1)`` the window's time with no frame graph on the
device, put down to the innermost host span then in flight.  ``tracing(False)`` turns the recorder
off: spans become one shared no-op and graphs captured after it hold no
stamps.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..domain import Domain
from ..state import ParticleState

Times = List[Tuple[str, float]]


def _first(out) -> torch.Tensor:
    """The first tensor of a phase's result (a tensor, or a tuple or
    dataclass whose first item leads to one)."""
    while not isinstance(out, torch.Tensor):
        out = out[0] if isinstance(out, (tuple, list)) else next(iter(vars(out).values()))
    return out


def timed(times: Times, label: str, device: torch.device, fn: Callable, *args):
    """Run ``fn(*args)`` on ``device``, append (label, seconds) to
    ``times``, return its result."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn(*args)
        secs = time.perf_counter() - t0
    float(_first(out).reshape(-1)[0])  # a real read: surfaces device faults
    times.append((label, secs))
    return out


class PhaseTimer:
    """Runs frames phase by phase, reporting the last substep's times."""

    def __init__(self, cfg: Config, domain: Domain, backend: str = "dense"):
        from ..step import _get_backend

        self.cfg = cfg
        self.domain = domain
        self._ops = _get_backend(backend)

    def frame(self, p: ParticleState, mouse_pos, mouse_active) -> Tuple[ParticleState, Times]:
        cfg, dom, ops, dev = self.cfg, self.domain, self._ops, p.device
        times: Times = []
        for _ in range(cfg.iterations):
            times.clear()  # keep only the last substep (2d_multi.rs:112)
            if not hasattr(ops, "p2g_1"):
                # the simulation always runs the requested backend: timing
                # must never change what is simulated
                p, _ = timed(times, "substep", dev, ops.substep, p, cfg, dom, mouse_pos, mouse_active)
                continue
            grid = timed(times, "p2g 1", dev, ops.p2g_1, p, cfg, dom)
            grid, rho, prs = timed(times, "p2g 2", dev, ops.p2g_2, p, grid, cfg, dom)
            grid = timed(times, "update", dev, ops.grid_update, grid, cfg)
            p = timed(times, "g2p", dev, ops.g2p, p, grid, cfg, dom, mouse_pos, mouse_active,
                      rho, prs)
        return p, times


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

# device stamp tags (csrc/graph_if.cu writes them as given)
FRAME_BEGIN, FRAME_END, REBIN_BEGIN, REBIN_END, ANCHOR = range(5)
DEVICE_SPANS = (("frame", FRAME_BEGIN, FRAME_END), ("rebin", REBIN_BEGIN, REBIN_END))
BETWEEN = "between calls"
SPANS = 1 << 18  # host records: ~29,000 app frames of 9 spans; older ones read as lost
STAMPS = 1 << 17  # device stamps a device: 2 a frame and 2 a re-bin
COUNTS = 1 << 17  # counter samples: three a strict check, ~63k in 50 s of the 2D app loop
ANCHOR_TRIES = 8  # eager stamps an anchor takes the tightest of
ANCHORS_KEPT = 64  # the first anchor and the latest others


class _Noop:
    """The span of a recorder that is off: shared, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    """``with`` a host span of one name; one object a name, reused."""

    __slots__ = ("rec", "code")

    def __init__(self, rec: "Recorder", code: int):
        self.rec, self.code = rec, code

    def __enter__(self):
        self.rec._open.append(time.perf_counter_ns())

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        t0 = rec._open.pop()
        i = rec._written & rec._mask
        rec._written += 1  # as Recorder.record, inlined: ~10 spans close in each app frame
        rec._code[i], rec._depth[i], rec._t0[i], rec._t1[i] = self.code, len(rec._open), t0, t1
        return False


@dataclasses.dataclass
class Records:
    """A window's records, times in host ``perf_counter_ns``.

    spans : (name, depth, start, end) of the host spans that overlap the
        window, by start (a parent before its children)
    device : (name, begin, end) of the device spans, "frame" and "rebin",
        that overlap the window, by begin
    dropped : host records the full ring lost, in the whole run
    stamps : device stamps the rings hold, in the whole run
    stamps_dropped : device stamps the full rings lost, in the whole run
    residual_ns : the largest distance of an anchor from the clock fit
    anchors : anchors the fit rests on (all devices)
    anchor_ns : the widest anchor's half interval: how far its stamp can
        lie from the host time it is given
    counts : (name, time, value, limit) of the counter samples taken in
        the window, by time
    lost : a full ring may have lost records of the window (host spans,
        counter samples or device stamps): it starts before the oldest one
        its ring still holds, and that ring has dropped some
    """

    spans: list
    device: list
    dropped: int = 0
    stamps: int = 0
    stamps_dropped: int = 0
    residual_ns: float = 0.0
    anchors: int = 0
    anchor_ns: float = 0.0
    counts: list = dataclasses.field(default_factory=list)
    lost: bool = False


def fit_clock(anchors) -> Tuple[Callable, float]:
    """The least-squares line through ``anchors``, (device ns, host ns,
    ...) tuples: (map, residual), ``map`` taking device ns (an int or an int64
    array) to host ns (float), ``residual`` the largest distance of an
    anchor from the line in ns.  One anchor: an offset alone."""
    d = np.array([a[0] for a in anchors], dtype=np.int64)
    h = np.array([a[1] for a in anchors], dtype=np.int64)
    d0, h0 = int(d[0]), int(h[0])
    x, y = (d - d0).astype(np.float64), (h - h0).astype(np.float64)
    if len(anchors) > 1 and np.ptp(x) > 0:
        slope, offset = np.polyfit(x, y, 1)
    else:
        slope, offset = 1.0, float(np.mean(y - x))

    def to_host(t):
        return h0 + offset + slope * (np.asarray(t, dtype=np.int64) - d0).astype(np.float64)

    return to_host, float(np.max(np.abs(to_host(d) - h)))


def pair_stamps(tags: np.ndarray, times: np.ndarray, begin: int, end: int) -> tuple:
    """(begins, ends) of each ``begin`` stamp and the first ``end`` stamp
    after it, where that comes before the next ``begin``; stamps in the
    order the device wrote them."""
    ib, ie = np.flatnonzero(tags == begin), np.flatnonzero(tags == end)
    k = np.searchsorted(ie, ib)
    ib, k = ib[k < len(ie)], k[k < len(ie)]
    e = ie[k]
    ok = e < np.append(ib[1:], len(tags))
    return times[ib[ok]], times[e[ok]]


def innermost(spans, t0: int, t1: int) -> list:
    """[t0, t1] cut into (start, end, path) pieces, each by the innermost
    host span then in flight (``path``: its name under its parents',
    "render/read"), or ``BETWEEN`` where none is; ``spans`` as
    ``Records.spans``."""
    out: list = []
    stack: list = []  # (end, path) of the spans open at ``cur``
    cur = t0

    def cut(a, b, path):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((a, b, path))

    for name, _, a, b in spans:
        while stack and stack[-1][0] <= a:
            end, path = stack.pop()
            cut(cur, end, path)
            cur = max(cur, end)
        cut(cur, a, stack[-1][1] if stack else BETWEEN)
        cur = max(cur, a)
        stack.append((b, f"{stack[-1][1]}/{name}" if stack else name))
    while stack:
        end, path = stack.pop()
        cut(cur, end, path)
        cur = max(cur, end)
    cut(cur, t1, BETWEEN)
    return out


def split_idle(spans, device, t0: int, t1: int) -> dict:
    """path -> seconds of [t0, t1] with no ``frame`` device span, by the
    innermost host span in flight (``innermost``); ``spans`` and
    ``device`` as ``Records`` holds them."""
    gaps, prev = [], t0
    for a, b in sorted((a, b) for name, a, b in device if name == "frame"):
        if a > prev:
            gaps.append((prev, min(a, t1)))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    out: dict = {}
    segs, i, j = innermost(spans, t0, t1), 0, 0
    while i < len(segs) and j < len(gaps):
        (a, b, path), (c, d) = segs[i], gaps[j]
        lo, hi = max(a, c), min(b, d)
        if hi > lo:
            out[path] = out.get(path, 0.0) + (hi - lo) * 1e-9
        if b <= d:
            i += 1
        else:
            j += 1
    return out


def idle_under(idle: dict, *owners: str) -> float:
    """Seconds of ``split_idle``'s ``idle`` under the top-level spans
    ``owners``."""
    return sum(v for k, v in idle.items() if k.split("/")[0] in owners)


class _Ring:
    """A device's stamp ring, on the card, and its copy on the host."""

    def __init__(self, device: torch.device, size: int):
        self.device, self.size = device, size
        self.times = torch.zeros(size, dtype=torch.int64, device=device)
        self.tags = torch.zeros(size, dtype=torch.int32, device=device)
        self.head = torch.zeros(1, dtype=torch.int64, device=device)
        self.anchor_times = torch.zeros(ANCHOR_TRIES, dtype=torch.int64, device=device)
        self.anchor_tags = torch.zeros(ANCHOR_TRIES, dtype=torch.int32, device=device)
        self.anchor_head = torch.zeros(1, dtype=torch.int64, device=device)
        self.host_times = np.zeros(size, dtype=np.int64)
        self.host_tags = np.zeros(size, dtype=np.int32)
        self.seen = 0  # stamps copied to the host
        self.anchors: list = []  # (device ns, host ns, half interval ns)

    def stamp(self, tag: int, anchor: bool = False) -> None:
        """Launch the stamp kernel on the current stream (captured where it
        captures)."""
        from .graph import LIBRARY

        times, tags, head, size = ((self.anchor_times, self.anchor_tags, self.anchor_head,
                                    ANCHOR_TRIES) if anchor
                                   else (self.times, self.tags, self.head, self.size))
        rc = LIBRARY.load().fluid_trace_stamp(
            ctypes.c_void_p(times.data_ptr()), ctypes.c_void_p(tags.data_ptr()),
            ctypes.c_void_p(head.data_ptr()), size - 1, tag,
            ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"trace stamp: CUDA error {rc}")

    def anchor(self) -> None:
        """One anchor: the tightest of ``ANCHOR_TRIES`` eager stamps, each
        between two synchronizes, at the middle of its host interval."""
        with torch.cuda.device(self.device):
            self.anchor_head.zero_()
            tries = []
            for _ in range(ANCHOR_TRIES):
                torch.cuda.synchronize()
                h0 = time.perf_counter_ns()
                self.stamp(ANCHOR, anchor=True)
                torch.cuda.synchronize()
                tries.append((time.perf_counter_ns() - h0, h0))
            dev = self.anchor_times.cpu().numpy()
        k = min(range(ANCHOR_TRIES), key=lambda i: tries[i][0])
        self.anchors.append((int(dev[k]), tries[k][1] + tries[k][0] // 2, tries[k][0] // 2))
        if len(self.anchors) > ANCHORS_KEPT:
            del self.anchors[1]

    def pull(self) -> tuple:
        """Copy the stamps written since the last pull to the host; return
        (tags, times) of those the ring still holds, oldest first."""
        head = int(self.head.cpu())  # synchronizes: stamps in flight land first
        start = max(self.seen, head - self.size)
        while start < head:
            a = start % self.size
            b = min(self.size, a + head - start)
            self.host_times[a:b] = self.times[a:b].cpu().numpy()
            self.host_tags[a:b] = self.tags[a:b].cpu().numpy()
            start += b - a
        self.seen = head
        first = max(0, head - self.size)
        order = np.arange(first, head) % self.size
        return self.host_tags[order], self.host_times[order]


class Recorder:
    """Host spans and device stamps of one process (module docstring).
    Spans nest on one stack, without a lock: one thread drives the sessions.

    ``spans`` and ``stamps``: ring sizes, powers of two."""

    def __init__(self, spans: int = SPANS, stamps: int = STAMPS, on: bool = True):
        if spans & (spans - 1) or stamps & (stamps - 1):
            raise ValueError("ring sizes are powers of two")
        self.on = on
        self._mask, self._stamps = spans - 1, stamps
        self._code = array.array("H", bytes(2 * spans))
        self._depth = array.array("B", bytes(spans))
        self._t0 = array.array("q", bytes(8 * spans))
        self._t1 = array.array("q", bytes(8 * spans))
        self._written = 0
        self._open: list = []  # starts of the spans open, innermost last
        self._names: list = []
        self._spans: dict = {}
        self._rings: dict = {}
        self._counts: deque = deque(maxlen=COUNTS)  # (name, time, value, limit)
        self._counted = 0  # samples taken, the ring's dropped ones too

    # -- host spans ---------------------------------------------------------

    def span(self, name: str):
        """A context that records a host span ``name`` (the shared no-op
        when the recorder is off)."""
        if not self.on:
            return _NOOP
        s = self._spans.get(name)
        if s is None:
            self._names.append(name)
            s = self._spans[name] = _Span(self, len(self._names) - 1)
        return s

    def record(self, name: str, t0: int, t1: int) -> None:
        """A host span ``name`` over [t0, t1] (perf_counter_ns) timed by the
        caller, inside the spans open now."""
        s = self.span(name)
        if s is _NOOP:
            return
        i = self._written & self._mask
        self._written += 1
        self._code[i], self._depth[i], self._t0[i], self._t1[i] = s.code, len(self._open), t0, t1

    @property
    def dropped(self) -> int:
        return max(0, self._written - self._mask - 1)

    def _spans_lost(self, t0: int) -> bool:
        """Whether the full host ring may have lost spans that end after
        ``t0``: it has dropped some, and the oldest it holds (the first to
        end of those it holds, as spans are written as they close) ends
        after ``t0``."""
        return self.dropped > 0 and t0 < self._t1[self._written & self._mask]

    def _counts_lost(self, t0: int) -> bool:
        """Whether the full counter ring may have lost samples taken at or
        after ``t0``."""
        return self._counted > len(self._counts) and t0 <= self._counts[0][1]

    def _host_spans(self, t0: int, t1: int) -> list:
        n = min(self._written, self._mask + 1)
        order = np.arange(self._written - n, self._written) % (self._mask + 1)
        a = np.frombuffer(self._t0, dtype=np.int64)[order]
        b = np.frombuffer(self._t1, dtype=np.int64)[order]
        depth = np.frombuffer(self._depth, dtype=np.uint8)[order]
        code = np.frombuffer(self._code, dtype=np.uint16)[order]
        keep = np.flatnonzero((a < t1) & (b > t0))
        keep = keep[np.lexsort((depth[keep], a[keep]))]
        names = self._names
        return [(names[c], int(d), int(x), int(y))
                for c, d, x, y in zip(code[keep], depth[keep], a[keep], b[keep])]

    # -- counter samples ----------------------------------------------------

    def count(self, name: str, value: int, limit: int = 0, at: Optional[int] = None) -> None:
        """A sample of counter ``name``: ``value`` (and the ``limit`` it is
        held to) at ``at`` (perf_counter_ns; None: now); nothing while the
        recorder is off.  The ring keeps the latest ``COUNTS``."""
        if self.on:
            self._counts.append((name, time.perf_counter_ns() if at is None else int(at),
                                 int(value), int(limit)))
            self._counted += 1

    # -- device stamps ------------------------------------------------------

    def ring(self, device) -> Optional[_Ring]:
        """The stamp ring on CUDA ``device``, made (and first anchored) at
        first call; None while the recorder is off.  Call it outside any
        capture: a graph captured later holds its pointers."""
        if not self.on:
            return None
        r = self._rings.get(device)
        if r is None:
            r = self._rings[device] = _Ring(device, self._stamps)
            r.anchor()
        return r

    def _device_records(self, t0: int, t1: int) -> tuple:
        """(device spans, stamps held, stamps dropped, residual ns,
        anchors, anchor half interval ns), each ring pulled and anchored
        anew."""
        out, held, dropped, residual, anchors, half = [], 0, 0, 0.0, 0, 0.0
        for r in self._rings.values():
            tags, times = r.pull()
            held += len(tags)
            r.anchor()
            to_host, res = fit_clock(r.anchors)
            residual, anchors = max(residual, res), anchors + len(r.anchors)
            half = max([half] + [a[2] for a in r.anchors])
            dropped += max(0, r.seen - r.size)
            for name, begin, end in DEVICE_SPANS:
                a, b = pair_stamps(tags, times, begin, end)
                a, b = to_host(a), to_host(b)
                keep = (a < t1) & (b > t0)
                out += [(name, x, y) for x, y in zip(a[keep].tolist(), b[keep].tolist())]
        out.sort(key=lambda s: s[1])
        return out, held, dropped, residual, anchors, half

    def _stamps_lost(self, t0: int) -> bool:
        """Whether a full stamp ring may have lost stamps written after
        ``t0``: it has dropped some, and the oldest it held at its last pull
        comes after ``t0``."""
        for r in self._rings.values():
            if r.seen > r.size and t0 < fit_clock(r.anchors)[0](r.host_times[r.seen % r.size]):
                return True
        return False

    def stamps(self) -> int:
        """Device stamps written so far, on every device (synchronizes)."""
        return sum(int(r.head.cpu()) for r in self._rings.values())

    # -- readout ------------------------------------------------------------

    def records(self, t0: Optional[int] = None, t1: Optional[int] = None) -> Records:
        """The host and device spans that overlap [t0, t1] and the counter
        samples taken in it (perf_counter_ns; None: unbounded)."""
        t0 = -(1 << 62) if t0 is None else int(t0)
        t1 = 1 << 62 if t1 is None else int(t1)
        device, *stamps = self._device_records(t0, t1)
        lost = self._spans_lost(t0) or self._counts_lost(t0) or self._stamps_lost(t0)
        return Records(self._host_spans(t0, t1), device, self.dropped, *stamps,
                       counts=[c for c in self._counts if t0 <= c[1] <= t1], lost=lost)

    def idle_by_span(self, t0: int, t1: int) -> Optional[dict]:
        """path -> seconds of [t0, t1] with no frame graph on the device, by
        the innermost host span in flight (``split_idle``); None where the
        recorder holds no device stamp, or where its rings may have lost
        records of the window (``Records.lost``)."""
        rec = self.records(t0, t1)
        if not rec.stamps or rec.lost:
            return None
        return split_idle(rec.spans, rec.device, int(t0), int(t1))

    def gap_after(self, name: str, after: int) -> Optional[Tuple[int, int]]:
        """(end, start): the end of the first top-level span ``name`` that
        starts after ``after`` (ns) and the start of the next one; None
        without two, or where the full ring may have lost spans after
        ``after`` (the first two it holds need not be the first two)."""
        if self._spans_lost(int(after)):
            return None
        found = [(a, b) for n, d, a, b in self._host_spans(int(after), 1 << 62)
                 if n == name and d == 0 and a >= after]
        return (found[0][1], found[1][0]) if len(found) > 1 else None


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process's recorder."""
    return _RECORDER


def tracing(on: bool) -> None:
    """Turn the recorder on or off (it starts on).  Off, a span records
    nothing and a frame graph captured from then on holds no stamp; call it
    before a ``Session`` captures its graph (its first frame, or
    ``compile_run``): a graph already captured keeps stamping."""
    _RECORDER.on = bool(on)


def span(name: str):
    """``recorder().span(name)``."""
    return _RECORDER.span(name)


def frame_overlay(t0: int, t1: int) -> Times:
    """The ``--timing`` lines of one app frame over [t0, t1]
    (perf_counter_ns).  With device stamps: the frame graph's device time,
    the re-bins' device time (their count in the label), and the device's
    idle time (no frame graph on it) under the render, the strict check and
    the sync.  Without (on the CPU, where the frame runs eagerly): the host
    spans render, mouse, replay, check and sync."""
    rec = _RECORDER.records(t0, t1)
    dev = [(n, a, b) for n, a, b in rec.device if a >= t0 and b <= t1]
    if not dev:
        host = {"render": 0.0, "mouse": 0.0, "replay": 0.0, "check": 0.0, "sync": 0.0}
        for name, depth, a, b in rec.spans:
            if name in host and a >= t0 and b <= t1:
                host[name] += (b - a) * 1e-9
        return list(host.items())
    idle = split_idle(rec.spans, rec.device, t0, t1)
    rebins = [b - a for n, a, b in dev if n == "rebin"]
    return [("frame device", sum(b - a for n, a, b in dev if n == "frame") * 1e-9),
            (f"rebin device ({len(rebins)})", sum(rebins) * 1e-9),
            ("render idle", idle_under(idle, "render")),
            ("check idle", sum(v for k, v in idle.items() if k.endswith("/check"))),
            ("sync idle", idle_under(idle, "sync"))]
