"""ASCII density renderer (PyTorch port of ``fluid_tpu/render.py``).

Particles bin into an 80x40 console grid (3D projects onto xy,
``3d_multi.rs:473``); counts map onto the ramp ``' .-=*%$#'``
(``2d_multi.rs:465-474``).  The histogram is reduced on the particles'
device, so a frame moves only the count grid to the host; ``render`` is
the whole path from a ``ParticleState`` to console lines.

``console_histogram`` is the histogram's wrapper: for CPU tensors it runs
the plain PyTorch version, ``histogram_xy``; for CUDA tensors it calls the
hand-written kernel's entry point (``csrc/render_kernels.cu``, built into
the stream library, ``ops/stream_kernels.LIBRARY``), which zeroes the grid
and launches the kernel over the live slots, and raises if that reports an
error, with no fallback to the plain version.
``LAUNCHES["console_histogram"]`` counts its calls.  A ``ConsoleView``
renders fixed buffers at one viewport and console, which on the card is
one CUDA graph of the zeroing, the kernel and the grid's copy into pinned
memory, so that a caller that renders every frame (``Session.render``)
makes one replay and one wait on the stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops.stream_kernels import _launch, _on_cpu, _ptr

RAMP = " .-=*%$#"
DEFAULT_VIEWPORT = (64.0, 64.0)  # 2d_multi.rs:515
DEFAULT_CONSOLE = (80, 40)  # 2d_multi.rs:516 (width, height)

_RAMP_BYTES = np.frombuffer(RAMP.encode("ascii"), dtype=np.uint8)
LAUNCHES = {"console_histogram": 0}


def histogram_xy(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                 viewport_size, console_size: Tuple[int, int]) -> torch.Tensor:
    """(H, W) int32 counts of the points (x, y) where ``valid``; points
    outside the console are skipped (``2d_multi.rs:452-454``).  The plain
    version of ``console_histogram``."""
    w, h = console_size
    cx = torch.floor(x / float(viewport_size[0]) * w).to(torch.int64)
    cy = torch.floor(y / float(viewport_size[1]) * h).to(torch.int64)
    ok = valid & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    flat = cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
    counts = torch.zeros((h * w,), dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat.reshape(-1), ok.reshape(-1).to(torch.int32))
    return counts.reshape(h, w)


class ConsoleView:
    """The render of fixed point buffers (``console_histogram``'s x, y and
    count, which later writes to them leave in place) at one viewport and
    console into its own grid, ``counts``.  ``histogram()`` puts the count
    grid on its way to the host; ``read()`` waits for it and returns it
    there.  On the card the grid's zeroing, the kernel and the grid's copy
    into pinned memory (``host``) are one CUDA graph, captured at the first
    ``histogram()`` (which runs them eagerly) and replayed by each one
    after: one host call, and ``read`` one wait on the stream, after which
    no copy is in flight into ``host``.  On the CPU the plain version runs
    at each ``histogram()``."""

    def __init__(self, x, y, count, viewport_size, console_size):
        self.args = (x, y, count, tuple(viewport_size), tuple(console_size))
        w, h = console_size
        self.counts = torch.empty((h, w), dtype=torch.int32, device=x.device)
        self.host = (torch.empty((h, w), dtype=torch.int32, pin_memory=True)
                     if x.device.type == "cuda" else None)
        self.graph = None

    def _launch(self) -> None:
        console_histogram(*self.args, out=self.counts)
        self.host.copy_(self.counts, non_blocking=True)

    def histogram(self) -> torch.Tensor:
        """The count grid on the device (``counts``), its copy to the host
        enqueued on the card."""
        if self.host is None:
            return console_histogram(*self.args, out=self.counts)
        if self.graph is not None:
            self.graph.replay()
            return self.counts
        self._launch()  # builds the library and runs the render once, eagerly
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._launch()
        self.graph = graph
        return self.counts

    def read(self) -> torch.Tensor:
        """The count grid on the host, after ``histogram()``."""
        if self.host is None:
            return self.counts
        torch.cuda.current_stream(self.counts.device).synchronize()
        return self.host


def console_histogram(x: torch.Tensor, y: torch.Tensor, count: Optional[torch.Tensor],
                      viewport_size, console_size: Tuple[int, int],
                      out: Optional[torch.Tensor] = None, x_shift: float = 0.0) -> torch.Tensor:
    """(H, W) int32 counts of the points (x + ``x_shift``, y): x and y are
    [R, S] rows of slots with the same strides, of which the first
    ``count[r]`` slots of row r are live (``count`` [R] int32; None: every
    slot), or [N] (one row).  Written into ``out`` (an (H, W) int32 grid on
    x's device; None: a new one) and returned."""
    if x.dim() == 1:
        x, y = x[None], y[None]
    R, S = x.shape
    dev = x.device
    if x.dtype != torch.float32 or y.dtype != torch.float32 or y.shape != x.shape:
        raise ValueError(f"console_histogram: x {tuple(x.shape)} {x.dtype} and y "
                         f"{tuple(y.shape)} {y.dtype}, expected float32 of one shape")
    if y.device != dev or y.stride() != x.stride():
        raise ValueError("console_histogram: x and y need one device and one layout")
    if count is not None and (count.shape != (R,) or count.dtype != torch.int32
                              or count.device != dev or not count.is_contiguous()):
        raise ValueError(f"console_histogram: count {tuple(count.shape)} {count.dtype}, "
                         f"expected [{R}] int32 on {dev}")
    console_size = tuple(console_size)
    w, h = console_size
    if out is None:
        out = torch.empty((h, w), dtype=torch.int32, device=dev)
    if (out.shape != (h, w) or out.dtype != torch.int32 or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(f"console_histogram: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, expected ({h}, {w}) int32 on {dev}")
    if _on_cpu(dev):
        valid = (torch.ones((R, S), dtype=torch.bool) if count is None
                 else torch.arange(S)[None, :] < count[:, None])
        return out.copy_(histogram_xy(x + x_shift if x_shift else x, y, valid,
                                      viewport_size, console_size))
    inv_w, inv_h = (float(np.float32(1.0) / np.float32(v)) for v in viewport_size)
    with torch.cuda.device(dev):
        _launch("console_histogram", "fluid_console_histogram", _ptr(x), _ptr(y), _ptr(count),
                x.stride(0), x.stride(1), R, S, inv_w, inv_h, x_shift, w, h, _ptr(out),
                counts=LAUNCHES)
    return out


def histogram(pos: torch.Tensor, viewport_size=DEFAULT_VIEWPORT,
              console_size: Tuple[int, int] = DEFAULT_CONSOLE) -> torch.Tensor:
    """Bin [..., D] positions (xy only) into an (H, W) int32 count grid:
    ``console_histogram`` over one row of every point."""
    flat = pos.reshape(-1, pos.shape[-1])
    return console_histogram(flat[:, 0], flat[:, 1], None, viewport_size, console_size)


def ascii_frame(counts) -> list[str]:
    """Map an (H, W) count grid on the host (an array or a CPU tensor) to
    console lines via the reference ramp: a byte table, indices clipped to
    the ramp, and one decode."""
    counts = np.asarray(counts)
    h, w = counts.shape
    text = np.take(_RAMP_BYTES, counts, mode="clip").tobytes().decode("ascii")
    return [text[i:i + w] for i in range(0, h * w, w)] if w else [""] * h


def render(p, viewport_size=DEFAULT_VIEWPORT,
           console_size: Tuple[int, int] = DEFAULT_CONSOLE) -> list[str]:
    """Console lines of a ``ParticleState``: histogram on its device, then
    the ramp on the host."""
    return ascii_frame(histogram(p.pos, viewport_size, tuple(console_size)).cpu())
