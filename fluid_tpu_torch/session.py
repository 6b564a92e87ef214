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

Differences from the JAX ``Session``: PyTorch runs eagerly, so ``run(k)``
is a loop of ``frame()`` (the JAX session fuses k frames into one program)
and there is no ``compile_run`` (ahead-of-time compilation of that fused
program).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import render as render_mod
from . import step
from .config import Config
from .domain import Domain
from .ops import stream_transfer as stx
from .ops import tiled_transfer as tt
from .state import ParticleState
from .utils.platform import resolve_device


def default_backend(device=None) -> str:
    """"stream" (hand-written CUDA kernels) on a CUDA device, "dense" on the
    CPU, where the kernels' plain versions would only be slower.  ``device``
    None means ``default_device()``, the card (raises without one)."""
    return "stream" if resolve_device(device).type == "cuda" else "dense"


class Session:
    """Holds simulation state across frames.

    cfg, domain : static setup;  p : initial particles (moved to ``device``)
    backend : one of ``step.BACKENDS``; None -> ``default_backend(device)``
    spec : layout override: a StreamSpec for "stream", a TileSpec for
        "tiled"; None is the backend's default ("pallas" always uses
        ``tiled_transfer.default_spec``, as in JAX)
    strict : after every frame check particle conservation and the
        active-budget watermark (stream only; one small device read)
    device : where the state lives (None: ``default_device()``, the card)
    """

    def __init__(self, cfg: Config, domain: Domain, p: ParticleState,
                 backend: Optional[str] = None, spec=None, strict: bool = True,
                 device=None):
        self.device = resolve_device(device)
        p = p.to(self.device)
        self.cfg = cfg
        self.domain = domain
        self.backend = backend or default_backend(self.device)
        self.n = p.n
        self.dim = p.dim
        self.strict = strict
        self._frames = 0
        if self.backend == "stream":
            self.spec = spec if spec is not None else stx.default_spec(cfg, domain, p.n)
            over = int(stx.overflow_count(p.pos, domain, self.spec, vel=p.vel, dt=cfg.dt))
            if over:
                raise ValueError(
                    f"stream spec overflow at t=0: {over} particles do not "
                    f"fit the slot structure (raise spec.active/cap)"
                )
            self._st = stx.bin_particles(p, domain, self.spec, dt=cfg.dt)
        elif self.backend in step.BACKENDS:
            self.spec = spec
            self._p = p
        else:
            raise ValueError(f"unknown backend {self.backend!r}")

    # -- frame loop ---------------------------------------------------------

    def frame(self, mouse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """Advance one frame (``cfg.iterations`` substeps)."""
        mp, ma = mouse if mouse is not None else step.no_mouse()
        if self.backend == "stream":
            self._st = stx.frame_binned(
                self._st, self.cfg, self.domain, self.spec, mp, ma, n=self.n
            )
            if self.strict:
                self._check(f"frame {self._frames}")
        elif self.backend == "tiled":
            self._p = tt.frame(self._p, self.cfg, self.domain, mp, ma, spec=self.spec)
        else:
            self._p = step.frame(self._p, self.cfg, self.domain, mp, ma, self.backend)
        self._frames += 1

    def _check(self, where: str) -> None:
        live = self.live_count()
        if live != self.n:
            raise RuntimeError(
                f"particle loss at {where}: sum(count)={live} != n={self.n} — "
                f"a re-bin overflowed the slot structure (raise spec.active/cap)"
            )
        drops = self.shell_drop()
        if drops:
            raise RuntimeError(
                f"active-budget exhaustion at {where}: {drops} needed relay "
                f"tiles dropped at a re-bin — physics invalid (raise spec.active)"
            )

    def run(self, frames: int, mouse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """Advance ``frames`` frames with the same mouse input."""
        for _ in range(frames):
            self.frame(mouse)

    def block_until_ready(self) -> None:
        """Wait for the device, then read one element: the read surfaces a
        device fault here rather than at some later call."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        src = self._st.stream if self.backend == "stream" else self._p.pos
        float(src.reshape(-1)[0])

    # -- state snapshot -----------------------------------------------------

    def snapshot(self):
        """Deep copy of the live state; ``restore`` replays from it."""
        src = self._st if self.backend == "stream" else self._p
        return self._frames, src.clone()

    def restore(self, snap) -> None:
        """Reset to a ``snapshot()`` (copies again, so a snapshot survives
        repeated restores)."""
        frames, src = snap
        if self.backend == "stream":
            self._st = src.clone()
        else:
            self._p = src.clone()
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

    def rebins(self) -> int:
        """Drift re-bins since the initial bin."""
        return int(self._st.rebins.max()) if self.backend == "stream" else 0

    def stream_state(self) -> stx.StreamState:
        if self.backend != "stream":
            raise ValueError("stream_state() requires the stream backend")
        return self._st

    def particles(self) -> ParticleState:
        """Current particles in their original order (un-bins on demand)."""
        if self.backend == "stream":
            return stx.unbin(self._st, self.domain, self.spec, self.n, self.dim)
        return self._p

    def histogram(self, viewport_size, console_size) -> torch.Tensor:
        """(H, W) int32 console counts, reduced on the device; the stream
        backend bins straight from the valid slots, without un-binning."""
        if self.backend == "stream":
            st = self._st
            cap = self.spec.cap
            valid = torch.arange(cap, device=self.device)[None, :] < st.count[:, None]
            return render_mod.histogram_xy(
                st.stream[:, 0, :], st.stream[:, 1, :], valid,
                viewport_size, tuple(console_size),
            )
        return render_mod.histogram(self._p.pos, viewport_size, tuple(console_size))

    def render(self, viewport_size, console_size) -> list:
        return render_mod.ascii_frame(self.histogram(viewport_size, console_size))
