"""Interactive terminal app (PyTorch port of ``fluid_tpu/app.py``): the
reference's ``main`` loop (``2d_multi.rs:491-544`` / ``3d_multi.rs:514-568``)
plus a headless mode.

Per frame: poll input, map console coordinates to the world
(``2d_multi.rs:525-527``), draw, step, sleep ``dt``.  The terminal is in raw
mode on the alternate screen with mouse capture; a stdin reader thread feeds
Quit and Drag events through a queue of one that drops drags when full, and
the terminal is restored in a ``finally`` block.

``--headless --frames N`` prints each frame and its timing lines without a
TTY.  ``--timing`` shows phase times: the dense phases (``p2g 1``, ``p2g 2``,
``update``, ``g2p``) on "dense", one ``substep`` time on "sorted", "tiled"
and "pallas"; on "stream" the frame the session ran, from the recorder
(``utils/timing.frame_overlay``): on the card the frame graph's device
time, the re-bins' device time and count, and the device's idle time
under the render, the strict check and the sync; on the CPU, where the
frame runs eagerly, the host spans.  ``--shards N`` runs the sharded stream
backend (``parallel/stream_shard.ShardedSession``) over the first N cards,
or over N CPU shards with ``--cpu``; it has no timing overlay.

The state lives on the card unless ``--cpu`` (``device="cpu"``) is given;
without a card the app exits with an error, it never falls back to the CPU.

The stream ``Session`` runs strict, at the slot cap ``default_spec`` sizes
from the scene: in 2D (four particles a cell, sixteen cells a tile) 256
slots, room for the ring the mouse packs when it pushes into the block; in
3D 128.  A lost particle is never silent: a re-bin that asks a tile for
more than its cap raises ``RuntimeError`` at the frame's strict check.

Usage::

    python -m fluid_tpu_torch.app --dim 2            # interactive, q quits
    python -m fluid_tpu_torch.app --dim 3 --headless --frames 10
    python -m fluid_tpu_torch.app --cpu --dim 2 --frames 2 --headless
    python -m fluid_tpu_torch.app --cpu --backend tiled --frames 3 --headless
    python -m fluid_tpu_torch.app --cpu --shards 2 --frames 2 --headless
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import render as render_mod
from . import scene, step
from .config import default_2d, default_3d
from .session import Session, default_backend
from .utils.platform import cuda_devices, require_cuda, resolve_device
from .utils.timing import PhaseTimer, frame_overlay

@dataclass
class Quit:
    pass


@dataclass
class Drag:
    col: int
    row: int


def _event_reader(q: "queue.Queue", stop: threading.Event) -> None:
    """Blocking stdin reader (``event_handler``, ``2d_multi.rs:413-436``):
    'q' quits, SGR mouse reports (``ESC [ < b ; x ; y M``) press or drag.
    Drags are dropped when the queue is full, Quit waits for room."""
    buf = b""
    while not stop.is_set():
        ch = sys.stdin.buffer.read(1)
        if not ch:
            return
        buf += ch
        if buf.endswith(b"q") and not buf.startswith(b"\x1b"):
            q.put(Quit())
            return
        if not buf.startswith(b"\x1b"):
            buf = b""
        elif buf[-1:] in (b"M", b"m") and b"<" in buf:
            try:
                b_code, x, y = (int(v) for v in buf[buf.index(b"<") + 1:-1].decode().split(";"))
                if buf.endswith(b"M") and (b_code & 3) != 3:
                    q.put_nowait(Drag(x - 1, y - 1))
            except (ValueError, queue.Full):
                pass
            buf = b""
        elif len(buf) > 32:
            buf = b""


def _setup_terminal() -> list:
    """Raw mode, alternate screen, hidden cursor, SGR mouse capture
    (``setup_terminal``, ``2d_multi.rs:393-401``)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setraw(fd)
    sys.stdout.write("\x1b[?1049h\x1b[?25l\x1b[?1002h\x1b[?1006h")
    sys.stdout.flush()
    return old


def _restore_terminal(old) -> None:
    """(``restore_terminal``, ``2d_multi.rs:403-411``)."""
    import termios

    sys.stdout.write("\x1b[?1006l\x1b[?1002l\x1b[?25h\x1b[?1049l")
    sys.stdout.flush()
    termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)


def run(dim: int = 2, n: int = scene.REFERENCE_N, seed: int = 0,
        frames: Optional[int] = None, headless: bool = False, backend: str = "auto",
        timing: bool = False, out=None, device=None, shards: Optional[int] = None) -> None:
    """The app's loop on a reference dam break of ``n`` particles;
    ``device`` None means the card.  ``shards``: a ShardedSession over the
    first ``shards`` cards, or ``shards`` CPU shards on a CPU ``device``."""
    out = out or sys.stdout
    device = resolve_device(device)
    cfg = default_2d() if dim == 2 else default_3d()
    p, dom = scene.dam_break(torch.Generator().manual_seed(seed), cfg, n=n, device=device)
    if backend == "auto":
        backend = default_backend(device)

    viewport = render_mod.DEFAULT_VIEWPORT
    console = render_mod.DEFAULT_CONSOLE
    timer = sess = None
    if shards:
        from .parallel.stream_shard import ShardedSession

        devices = [device] * shards if device.type == "cpu" else cuda_devices(shards)
        sess = ShardedSession(cfg, dom, p, devices=devices)
    elif timing and backend != "stream":
        # the timer drives the requested backend phase by phase
        timer = PhaseTimer(cfg, dom, backend=backend)
    else:
        # the session keeps the stream state binned across frames
        sess = Session(cfg, dom, p, backend=backend, device=device)

    ev_q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()
    old_term = None
    if not headless:
        old_term = _setup_terminal()
        threading.Thread(target=_event_reader, args=(ev_q, stop), daemon=True).start()

    frame_i = 0
    try:
        while frames is None or frame_i < frames:
            mouse = step.no_mouse()
            try:
                ev = ev_q.get_nowait()
                if isinstance(ev, Quit):
                    break
                # console -> world (2d_multi.rs:525-527)
                mouse = step.mouse((ev.col / console[0] * viewport[0],
                                    ev.row / console[1] * viewport[1]))
            except queue.Empty:
                pass

            t0 = time.perf_counter_ns()
            if timer is not None:
                lines = render_mod.render(p, viewport, console)
                p, phase_times = timer.frame(p, *mouse)
            else:
                lines = sess.render(viewport, console)
                sess.frame(mouse)
                sess.block_until_ready()
                t1 = time.perf_counter_ns()
                phase_times = [("frame", (t1 - t0) * 1e-9)]
                if timing:
                    phase_times = frame_overlay(t0, t1) + phase_times

            if headless:
                out.write(f"--- frame {frame_i} ---\n")
                out.write("\n".join(lines) + "\n")
                for label, secs in phase_times:
                    out.write(f"{label}: {secs * 1e3:.3f}ms\n")
            else:
                buf = [f"\x1b[{y + 1};1H{line}" for y, line in enumerate(lines)]
                buf += [f"\x1b[{console[1] + 1 + i};1H{label}: {secs * 1e3:.3f}ms\x1b[0K"
                        for i, (label, secs) in enumerate(phase_times)]
                buf.append("\x1b[0J")
                out.write("".join(buf))
                out.flush()

            frame_i += 1
            if not headless:
                time.sleep(cfg.dt)  # 2d_multi.rs:538
    finally:
        stop.set()
        if old_term is not None:
            _restore_terminal(old_term)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="fluid-tpu interactive dam-break (PyTorch/CUDA)")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--particles", type=int, default=scene.REFERENCE_N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=None, help="stop after N frames")
    ap.add_argument("--headless", action="store_true", help="no TTY; print frames")
    ap.add_argument(
        "--backend", default="auto",
        choices=("auto", "dense", "sorted", "tiled", "pallas", "stream"),
        help="transfer backend; auto = stream on the card, dense with --cpu",
    )
    ap.add_argument("--timing", action="store_true", help="per-phase timing overlay")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--shards", type=int, default=None,
                    help="run the sharded stream backend over N cards (with --cpu: N CPU shards)")
    args = ap.parse_args(argv)
    if args.timing and args.shards:
        raise SystemExit("--timing is single-device only (drop --shards)")
    if args.cpu:
        device = torch.device("cpu")
    else:
        try:
            device = require_cuda()
            if args.shards:
                cuda_devices(args.shards)
        except RuntimeError as e:
            raise SystemExit(f"error: {e}; pass --cpu to run on the CPU") from None
    run(dim=args.dim, n=args.particles, seed=args.seed, frames=args.frames,
        headless=args.headless, backend=args.backend, timing=args.timing, device=device,
        shards=args.shards)


if __name__ == "__main__":
    main()
