"""Per-phase timing (PyTorch port of ``fluid_tpu/utils/timing.py``).

The reference times each phase of a substep and shows the last substep's
times under the render (``2d_multi.rs:112-132,479-487``).  ``PhaseTimer``
runs a frame phase by phase with those labels (``clear`` is gone: the
deposits start from zeros); a backend without separate phases ("stream",
"pallas") is timed a whole substep at a time, under ``substep``.
``StreamPhaseTimer`` runs one substep of the stream path stage by stage on
the session's state after its frame, and discards what the stages return.

On a CUDA device a phase is timed with CUDA events around it; on the CPU
with the host clock.  Either way one element of the phase's result is read
afterwards, so a device fault shows up at the phase that caused it.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

from ..config import Config
from ..domain import Domain
from ..ops import stream_transfer as stx
from ..state import ParticleState
from ..step import _get_backend
from .platform import resolve_device

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


class StreamPhaseTimer:
    """Stage times of the stream path's substep.

    The session's frame stays the one that simulates; ``probe`` runs each
    stage of one unfused substep (``substep_stages``: the kernels the frame
    launches) and a re-bin on the session's binned state, and discards the
    outputs.  The first probe includes the kernels' build.  ``device`` None
    means ``default_device()``, the card.
    """

    def __init__(self, cfg: Config, domain: Domain, spec, n: int, device=None):
        self.cfg, self.domain, self.spec, self.n = cfg, domain, spec, n
        self.device = resolve_device(device)
        self._stages = stx.substep_stages(cfg, domain, spec, self.device, fused=False)
        self._tshape, self._nt = stx._tile_geometry(domain, spec)

    def probe(self, st, mouse_pos, mouse_active) -> Times:
        """One substep's stage times on ``st`` (the state is not advanced)."""
        s, dev = self._stages, self.device
        params = stx.collect_params(self.cfg, mouse_pos, mouse_active,
                                    self.spec.scene_stride, self.device)
        times: Times = []
        d1 = timed(times, "dep1", dev, s.dep1, st)
        hm = timed(times, "halo m", dev, s.halo_m, st, d1)
        d2 = timed(times, "dep2 m+f", dev, s.dep2, st, d1, hm)
        gb = timed(times, "halo+gblk", dev, s.halo_gblk, st, d2, hm)
        timed(times, "collect", dev, s.collect, st, gb, params)
        timed(times, "rebin", dev, stx._rebin_full, st, self.cfg, self.domain, self.spec,
              self._tshape, self._nt, self.n)
        return times
