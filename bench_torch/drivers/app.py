"""The app loop without the terminal: ``Session.render``, ``frame(mouse)``,
``block_until_ready``, back to back with no sleep.

The mix's parameters (``traffic/<mix>.json``):

  drag          the mouse: ``share`` of the frames under a drag, each drag
                ``frames`` long (a range) along a line between two points
                uniform in the viewport, from a fixed ``set`` of drags drawn
                from ``set_seed`` that the run's seed orders; null: no mouse
  mouse_check   check a frame with the mouse on (below)
  trace_frames  frames of the traced stretch

The configuration's ``app`` group gives the viewport and the console.  With
``mouse_check`` the first frame after the graph's capture, from the fresh
scene, runs with the mouse at the fluid's xy centroid, through the window's
own ``frame(mouse)``: the impulse on a calm block (from the drags' splashes
the gaps swing by orders from seed to seed).
"""

from __future__ import annotations

import random
import time


def drag_set(drag: dict, viewport) -> list:
    """The mix's fixed set of ``drag["set"]`` drags, drawn once from
    ``drag["set_seed"]``, each as its frames' mouse positions followed by
    its idle gap (None a frame): a drag lasts a number of frames uniform in
    ``drag["frames"]`` and moves along the line between two points uniform
    in the viewport; the gap is sized so that a ``drag["share"]`` of the
    frames is under a drag."""
    make = random.Random(drag["set_seed"])
    lo, hi = drag["frames"]
    idle = (1.0 - drag["share"]) / drag["share"]
    pieces = []
    for _ in range(drag["set"]):
        length = make.randint(lo, hi)
        x0, y0, x1, y1 = (make.uniform(0.0, viewport[i % 2]) for i in range(4))
        path = [(x0 + (x1 - x0) * k / (length - 1), y0 + (y1 - y0) * k / (length - 1))
                for k in range(length)]
        pieces.append(path + [None] * max(1, round(make.randint(lo, hi) * idle)))
    return pieces


def drag_schedule(seed: int, drag: dict | None, viewport, frames: int) -> list:
    """Per frame the mouse's world (x, y), or None without a drag: the
    mix's ``drag_set``, ordered by ``seed`` anew for each pass through it,
    so every seed sends the same drags."""
    if drag is None:
        return [None] * frames
    pieces = drag_set(drag, viewport)
    order = random.Random(seed)
    out: list = []
    while len(out) < frames:
        order.shuffle(pieces)
        for piece in pieces:
            out += piece
    return out[:frames]


def setup(run, scenes: list) -> None:
    """The mouse check's frame (with ``mouse_check``), then one render and
    one frame of each kind off the clock."""
    tr, sess, step = run.traffic, run.sess, run.step
    app = run.conf["app"]
    run.viewport, run.console = app["viewport"], app["console"]
    run.schedule = drag_schedule(run.seed, tr["drag"], run.viewport,
                                 100_000 if tr["drag"] else 1)
    if tr.get("mouse_check"):
        start = run.particles()
        xy = [float(v) for v in start["pos"][:, :2].mean(dim=0)]
        sess.frame(step.mouse(xy))
        run.setup_checks.append({"prefix": "mouse_", "start": start, "got": run.particles(),
                                 "mouse": xy})
    sess.render(run.viewport, run.console)
    if tr["drag"]:
        sess.frame(step.mouse((run.viewport[0] / 2, run.viewport[1] / 2)))
    sess.frame()
    sess.block_until_ready()


def call(run, span) -> int:
    """One frame of the app; its latency runs from the mouse input set to
    the render on the host and the frame synchronised."""
    sess, step = run.sess, run.step
    t0 = time.perf_counter()
    xy = run.schedule[run.frames % len(run.schedule)]
    mouse = step.mouse(xy) if xy is not None else step.no_mouse()
    with span("render"):
        sess.render(run.viewport, run.console)
    if not run.tracing:
        run.render_s.append(time.perf_counter() - t0)
    with span("frame"):
        run.counted(lambda: sess.frame(mouse))
    with span("sync"):
        sess.block_until_ready()
    run.latencies.append(time.perf_counter() - t0)
    return 1


def check(run) -> list:
    """One more frame through the window's own call with the mouse off, as
    the idle frames make it, then its render."""
    sess = run.sess
    start = run.particles()
    sess.frame(run.step.no_mouse())
    sess.block_until_ready()
    got = run.particles()
    return [{"prefix": "", "start": start, "got": got, "mouse": None,
             "render": (sess.render(run.viewport, run.console), run.viewport, run.console)}]
