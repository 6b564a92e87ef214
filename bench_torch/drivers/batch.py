"""Batch calls: ``Session.run(frames_per_call)`` back to back, on one scene
or on fresh scenes kept as snapshots.

The mix's parameters (``traffic/<mix>.json``):

  scenes           scenes drawn from the seed (more than one with ``restore``)
  setup_frames     frames run untimed before the window
  restore          each call first restores the next scene's snapshot
  frames_per_call  frames of one ``run`` call
  sync             each call ends in ``block_until_ready``
  trace_frames     frames of the traced stretch
"""

from __future__ import annotations


def setup(run, scenes: list) -> None:
    """Snapshots of the scenes, the untimed frames, then one call of the
    window's kind off the clock; leaves the session at the window's start."""
    tr, sess = run.traffic, run.sess
    if tr["restore"]:
        run.snaps.append(sess.snapshot())
        for p in scenes[1:]:
            other = run.session_of(p)
            run.snaps.append(other.snapshot())
            del other
    left = tr["setup_frames"]
    while left > 0:
        sess.run(min(left, 10))
        left -= min(left, 10)
    if tr["restore"]:
        sess.restore(run.snaps[0])
    sess.run(1)
    if tr["restore"]:
        sess.restore(run.snaps[0])
    sess.block_until_ready()


def call(run, span) -> int:
    """One job; returns the frames it ran."""
    tr, sess = run.traffic, run.sess
    if tr["restore"]:
        with span("restore"):
            sess.restore(run.snaps[run.jobs % len(run.snaps)])
    with span("run"):
        run.counted(lambda: sess.run(tr["frames_per_call"]))
    if tr["sync"]:
        with span("sync"):
            sess.block_until_ready()
    return tr["frames_per_call"]


def check(run) -> list:
    """The check frame through the window's own call, ``run(1)``, from the
    state the window left (a restore mix: the next scene, run to the last
    frame of a call first)."""
    tr, sess = run.traffic, run.sess
    if tr["restore"]:
        sess.restore(run.snaps[run.jobs % len(run.snaps)])
        if tr["frames_per_call"] > 1:
            sess.run(tr["frames_per_call"] - 1)
    start = run.particles()
    sess.run(1)
    sess.block_until_ready()
    return [{"prefix": "", "start": start, "got": run.particles(), "mouse": None}]
