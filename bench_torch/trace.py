"""Reads a traced stretch of the window: device busy time, the device's work
by name, the idle gaps by what the host was doing, and the program's own
kernels apart from everything else.

``Stretch`` runs a stretch of calls under ``torch.profiler``, tracing the
card only (tracing the host's operations as well slowed a traced frame of
the reference scene about sixfold on the card).  The harness records its
own calls as host spans (``Stretch.span``) on the host clock; a spin kernel
launched on an idle card at a known host time ties that clock to the
profiler's, so each idle gap on the device is named by the harness call
then in flight.  The program's own kernels are the ``__global__`` functions
of its CUDA sources and the ``@triton.jit`` functions of its Python
modules, found by name in the program's files, so a kernel a later change
adds is its own without an edit here.
"""

from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path

import torch

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


def own_kernel_names(package: Path) -> tuple:
    """Names of the program's hand-written kernels: CUDA ``__global__``
    functions under ``package`` and its ``@triton.jit`` functions."""
    names = set()
    for src in list(package.rglob("*.cu")) + list(package.rglob("*.cuh")):
        names.update(_GLOBAL.findall(src.read_text(errors="replace")))
    for src in package.rglob("*.py"):
        text = src.read_text(errors="replace")
        if "triton" in text:
            names.update(_TRITON.findall(text))
    return tuple(sorted(names))


def is_own(name: str, own: tuple) -> bool:
    return any(re.search(rf"(^|[^\w]){re.escape(k)}($|[^\w])", name) for k in own)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Stretch:
    """``with Stretch(device) as st: ...`` profiles the calls inside, each
    made under ``st.span(name)``; after the block, ``read(own)`` gives the
    stretch's numbers."""

    SPIN = "spin_kernel"  # torch.cuda._sleep's kernel

    def __init__(self, device):
        self.device = device
        self.spans: list = []
        self.wall_s = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._t_spin = time.perf_counter()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self._t1 = time.perf_counter()
        self.wall_s = self._t1 - self._t0
        self.prof.__exit__(*exc)
        return False

    def read(self, own: tuple, top: int = 10) -> dict:
        """busy_s (the union of device activity in the stretch), window_s
        (the stretch's length), own_s and other_s (device time in the
        program's own kernels and in everything else), device_ops (the
        ``top`` names by device time), idle_gaps (the ``top`` longest gaps,
        each named by the harness call in flight).  Empty where the
        profiler saw no device work."""
        dev, spin = [], None
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type != torch.autograd.DeviceType.CUDA or b <= a:
                continue
            if getattr(e, "is_user_annotation", False):
                continue  # a host range's copy on the device's timeline
            if self.SPIN in e.name:
                spin = a if spin is None else max(spin, a)
            else:
                dev.append((e.name, a, b))
        if spin is None and not dev:
            return {}
        # host clock -> profiler us: by the spin, or, where the profiler lost
        # it, by the stretch's first device work
        base, at = (spin, self._t_spin) if spin is not None else (min(a for _, a, _ in dev), self._t0)

        def on_trace(t: float) -> float:
            return base + (t - at) * 1e6

        lo, hi = on_trace(self._t0), on_trace(self._t1)
        dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
        if not dev:
            return {}
        busy = _merge([(a, b) for _, a, b in dev])
        by_name: dict = {}
        own_us = 0.0
        for n, a, b in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
            if is_own(n, own):
                own_us += b - a
        gaps, prev = [], lo
        for a, b in busy + [[hi, hi]]:
            if a > prev + 1e-3:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [(n, on_trace(a), on_trace(b)) for n, a, b in self.spans]
        named = [[self._call_at(spans, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:top]]
        total = sum(by_name.values())
        return {
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "own_s": own_us * 1e-6,
            "other_s": (total - own_us) * 1e-6,
            "device_ops": [[n[:120], t * 1e-6]
                           for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": named,
        }

    @staticmethod
    def _call_at(spans, t) -> str:
        """The innermost harness call in flight at profiler time ``t``."""
        covering = [s for s in spans if s[1] <= t <= s[2]]
        return min(covering, key=lambda s: s[2] - s[1])[0] if covering else "between calls"
