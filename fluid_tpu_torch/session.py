"""Persistent-state frame driver (PyTorch port of ``fluid_tpu/session.py``).

``Session`` keeps the simulation state across frames, like the reference's
``Simulation`` (``3d_multi.rs:541-563``).  On the stream backend the state
stays binned on the device between frames; the console histogram is
reduced straight from the binned slots, and ``particles()`` un-bins on
demand.

The other backends ("dense", "sorted", "tiled", "pallas") hold a
``ParticleState`` and go through ``step.frame``, as in JAX; "tiled" runs
``tiled_transfer.frame`` with the session's ``spec``.  The state lives on
``device``, the card unless the caller passes ``device="cpu"``.

The session owns its state as static buffers and advances them in place
with one frame body (``utils/graph.FrameGraph``).  On the card a frame is
one CUDA graph, captured at the first ``frame()`` (or by ``compile_run``)
and replayed after that, so a frame makes no host read: the stream
frame's re-bins are decided by the card in IF nodes, and the mouse is
copied into a buffer of its own before each replay.  On the CPU the same
body runs eagerly.

Each call records host spans in the process's recorder
(``utils/timing.py``): ``frame`` and ``run`` (their parts ``mouse``,
``replay`` and ``check``), ``render`` (``histogram``, ``read``,
``ascii``), ``sync`` (``block_until_ready``), ``restore``, ``particles``
and ``snapshot``; the strict check also records the stream's ``fill_peak``
watermark beside its cap, its ``need_peak`` beside the active budget and
its ``occupied`` entries (those the kernels work on) beside the budget as
counter samples.

A batch of scenes runs on the stream backend in one ``PackedDomain``
(``scene.pack_scenes``): ``p`` holds the scenes' rows one scene after the
other, each in its own scene's coordinates, and ``particles()``,
``snapshot()`` and ``restore()`` keep that layout; each scene stays inside
its own walls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import render as render_mod
from . import step
from .config import Config
from .domain import Domain, packing
from .ops import stream_transfer as stx
from .ops import tiled_transfer as tt
from .state import FIELDS, ParticleState
from .utils.graph import FrameGraph
from .utils.platform import resolve_device
from .utils.timing import recorder, span


def default_backend(device=None) -> str:
    """"stream" (hand-written CUDA kernels) on a CUDA device, "dense" on the
    CPU, where the kernels' plain versions would only be slower.  ``device``
    None means ``default_device()``, the card (raises without one)."""
    return "stream" if resolve_device(device).type == "cuda" else "dense"


def _mouse_args(mouse: torch.Tensor):
    """(mouse_pos, mouse_active) of the session's (active, x, y) buffer."""
    return mouse[1:], mouse[0] != 0.0


# The frame bodies take no Session: a body that held its session (a bound
# method) would tie the session's graph to the cyclic garbage collector.
def _stream_body(cfg, domain, spec, mouse, n, st: stx.StreamState, branch) -> None:
    stx.frame_inplace(st, cfg, domain, spec, *_mouse_args(mouse), branch, n=n)


def _particle_body(cfg, domain, backend, spec, mouse, p: ParticleState, branch) -> None:
    """A frame of the backend's functional entry, copied into ``p``."""
    mp, ma = _mouse_args(mouse)
    if backend == "tiled":
        q = tt.frame(p, cfg, domain, mp, ma, spec=spec)
    else:
        q = step.frame(p, cfg, domain, mp, ma, backend)
    for f in FIELDS:
        getattr(p, f).copy_(getattr(q, f))


class Session:
    """Holds simulation state across frames.

    cfg, domain : static setup;  p : initial particles (moved to ``device``)
    backend : one of ``step.BACKENDS``; None -> ``default_backend(device)``
        (a packed domain of several scenes runs on "stream" alone)
    spec : layout override: a StreamSpec for "stream", a TileSpec for
        "tiled"; None is the backend's default ("pallas" always uses
        ``tiled_transfer.default_spec``, as in JAX); a StreamSpec whose
        ``scene_stride`` is not the domain's raises ValueError
    strict : after every frame check particle conservation and the
        active-budget watermark (stream only; one small device read, which
        also fetches the tile-fill and budget-demand watermarks and the
        occupied entries' count for the recorder)
    device : where the state lives (None: ``default_device()``, the card)
    """

    def __init__(self, cfg: Config, domain: Domain, p: ParticleState,
                 backend: Optional[str] = None, spec=None, strict: bool = True,
                 device=None):
        self.device = resolve_device(device)
        p = p.to(self.device).clone()  # the session's own buffers
        self.cfg = cfg
        self.domain = domain
        self.backend = backend or default_backend(self.device)
        scenes = packing(domain)[0]
        if scenes > 1 and self.backend != "stream":
            raise ValueError(f"{scenes} packed scenes run on the stream backend, "
                             f"not {self.backend!r}")
        self.n = p.n
        self.dim = p.dim
        self.strict = strict
        self._frames = 0
        # the mouse the graph reads: (active, x, y)
        self._mouse = torch.zeros((3,), dtype=torch.float32, device=self.device)
        self._staged = None
        self._views: dict = {}  # (viewport, console) -> render_mod.ConsoleView
        if self.backend == "stream":
            self.spec = spec if spec is not None else stx.default_spec(cfg, domain, p.n)
            over = int(stx.overflow_count(p.pos, domain, self.spec, vel=p.vel, dt=cfg.dt))
            if over:
                raise ValueError(
                    f"stream spec overflow at t=0: {over} particles do not "
                    f"fit the slot structure (raise spec.active/cap)"
                )
            self._st = stx.bin_particles(p, domain, self.spec, dt=cfg.dt)
            # the render's points: the live slots' x and y rows
            self._points = (self._st.stream[:, 0, :], self._st.stream[:, 1, :], self._st.count)
            body = functools.partial(_stream_body, cfg, domain, self.spec, self._mouse, self.n)
            self.frame_graph = FrameGraph(body, self._st, self.device)
        elif self.backend in step.BACKENDS:
            self.spec = spec
            self._p = p
            self._points = (p.pos[:, 0], p.pos[:, 1], None)  # the render's points: one row
            body = functools.partial(_particle_body, cfg, domain, self.backend, spec, self._mouse)
            self.frame_graph = FrameGraph(body, self._p, self.device)
        else:
            raise ValueError(f"unknown backend {self.backend!r}")

    # -- frame loop ---------------------------------------------------------

    def _set_mouse(self, mouse) -> None:
        """Copy (active, x, y) into the mouse buffer without a synchronizing
        call: on the device when the caller's tensors are there, else
        through pinned memory, kept until the next frame's copy."""
        mp, ma = mouse if mouse is not None else step.no_mouse()
        if mp.device == ma.device == self.device:
            self._mouse.copy_(torch.cat([ma.reshape(1).to(torch.float32),
                                         mp.reshape(2).to(torch.float32)]))
            return
        host = torch.cat([ma.cpu().reshape(1).to(torch.float32),
                          mp.cpu().reshape(2).to(torch.float32)])
        self._staged = host.pin_memory()
        self._mouse.copy_(self._staged, non_blocking=True)

    def frame(self, mouse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """Advance one frame (``cfg.iterations`` substeps); with ``strict``,
        check the stream state after it."""
        with span("frame"):
            with span("mouse"):
                self._set_mouse(mouse)
            with span("replay"):
                self.frame_graph.run()
            self._frames += 1
            if self.strict and self.backend == "stream":
                with span("check"):
                    self._check(f"frame {self._frames - 1}")

    def _check(self, where: str) -> None:
        st = self._st
        live, drops, fill, need, occupied = torch.cat(
            [st.count.sum(dtype=torch.int32).reshape(1), st.shell_drop, st.fill_peak,
             st.need_peak, st.occupied]).tolist()
        recorder().count("fill_peak", fill, self.spec.cap)
        recorder().count("need_peak", need, self.spec.A)
        recorder().count("occupied", occupied, self.spec.A)
        if live != self.n:
            raise RuntimeError(
                f"particle loss at {where}: sum(count)={live} != n={self.n} — "
                f"a re-bin overflowed the slot structure (raise spec.active/cap)"
            )
        if drops:
            raise RuntimeError(
                f"active-budget exhaustion at {where}: {drops} needed relay "
                f"tiles dropped at a re-bin — physics invalid (raise spec.active)"
            )

    def compile_run(self, frames: int = 1) -> None:
        """Warm up and capture the frame graph now, so that a timed ``run``
        excludes it; the state is left as it was.  JAX compiles one program
        per ``frames``; here one frame graph serves every ``frames``, which
        is accepted for the signature's sake.  No-op on the CPU."""
        self.frame_graph.capture()

    def run(self, frames: int, mouse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """Advance ``frames`` frames with the same mouse input: on the card
        ``frames`` replays with no host read between them; with ``strict``,
        the stream state is checked once after the span."""
        with span("run"):
            with span("mouse"):
                self._set_mouse(mouse)
            for _ in range(frames):
                with span("replay"):
                    self.frame_graph.run()
            self._frames += frames
            if self.strict and self.backend == "stream":
                with span("check"):
                    self._check(f"the {frames}-frame run ending at frame {self._frames - 1}")

    def block_until_ready(self) -> None:
        """Wait for the device, then read one element: the read surfaces a
        device fault here rather than at some later call."""
        with span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            src = self._st.stream if self.backend == "stream" else self._p.pos
            float(src.reshape(-1)[0])

    # -- state snapshot -----------------------------------------------------

    def snapshot(self):
        """Deep copy of the live state; ``restore`` replays from it."""
        with span("snapshot"):
            return self._frames, self.frame_graph.state.clone()

    def restore(self, snap) -> None:
        """Reset to a ``snapshot()``: copies into the session's buffers, in
        place (the frame graph reads them), so a snapshot survives repeated
        restores."""
        with span("restore"):
            frames, src = snap
            dst = self.frame_graph.state
            for f in dataclasses.fields(dst):
                getattr(dst, f.name).copy_(getattr(src, f.name))
            self._frames = frames

    # -- state access -------------------------------------------------------

    def live_count(self) -> int:
        """Particles in the slot structure (== n unless a re-bin overflowed)."""
        if self.backend == "stream":
            return int(self._st.count.sum())
        return self.n

    def shell_drop(self) -> int:
        """Watermark of needed-but-dropped relay tiles across (re-)bins;
        nonzero means the active budget was exhausted and the physics is
        invalid even if conservation holds."""
        return int(self._st.shell_drop.max()) if self.backend == "stream" else 0

    def need_peak(self) -> int:
        """Watermark of the needed-relay closure size (the budget demand)."""
        return int(self._st.need_peak.max()) if self.backend == "stream" else 0

    def fill_peak(self) -> int:
        """Watermark of the most particles a binning asked one tile to hold,
        before the clip to ``spec.cap`` (above the cap: particles were lost)."""
        return int(self._st.fill_peak.max()) if self.backend == "stream" else 0

    def rebins(self) -> int:
        """Drift re-bins since the initial bin."""
        return int(self._st.rebins.max()) if self.backend == "stream" else 0

    def stream_state(self) -> stx.StreamState:
        """The session's stream buffers themselves: the next frame writes
        over them (clone to keep)."""
        if self.backend != "stream":
            raise ValueError("stream_state() requires the stream backend")
        return self._st

    def particles(self) -> ParticleState:
        """Current particles in their original order (un-bins on demand): a
        copy, which later frames leave as it is."""
        with span("particles"):
            if self.backend == "stream":
                return stx.unbin(self._st, self.domain, self.spec, self.n, self.dim)
            return self._p.clone()

    def _view(self, viewport_size, console_size) -> render_mod.ConsoleView:
        """The session's render at ``viewport_size`` and ``console_size``,
        made at its first use and kept (on the card: its buffers and its
        captured graph)."""
        key = (tuple(viewport_size), tuple(console_size))
        view = self._views.get(key)
        if view is None:
            x, y, count = self._points
            view = self._views[key] = render_mod.ConsoleView(x, y, count, *key)
        return view

    def histogram(self, viewport_size, console_size) -> torch.Tensor:
        """(H, W) int32 console counts, reduced on the device into the
        session's own grid (the next render or histogram writes over it;
        clone to keep); the stream backend bins straight from the live
        slots, without un-binning."""
        return self._view(viewport_size, console_size).histogram()

    def render(self, viewport_size, console_size) -> list:
        """Console lines of the state: the histogram on the device (on the
        card one graph replay: the kernel and the grid's copy into pinned
        memory), the wait for the grid on the host, then the ramp."""
        with span("render"):
            view = self._view(viewport_size, console_size)
            with span("histogram"):
                view.histogram()
            with span("read"):
                counts = view.read()
            with span("ascii"):
                return render_mod.ascii_frame(counts)
