"""Batch calls on packed batches of scenes: set-up and calls as
``drivers/batch.py`` makes them, and the check frame split by scene.

The mix's parameters are ``drivers/batch.py``'s, and

  check_scenes     prefix -> the scene it names: "first", "last", or
                   "drawn" (an interior scene the run's seed draws, each
                   drawn scene another)

Each named scene's rows of the check frame (the configuration's
``scene.batch`` scenes, ``n / batch`` rows each, one after the other) are
compared with the reference on that scene alone, under the prefix.
"""

from __future__ import annotations

import random

from bench_torch import harness

_batch = harness.load_module("drivers", "batch")
setup, call = _batch.setup, _batch.call


def scenes_checked(run) -> dict:
    """prefix -> scene index of the traffic's ``check_scenes``."""
    batch = run.conf["scene"]["batch"]
    named = run.traffic["check_scenes"]
    drawn = random.Random(run.seed).sample(range(1, batch - 1),
                                           sum(v == "drawn" for v in named.values()))
    out = {}
    for prefix, what in named.items():
        out[prefix] = {"first": 0, "last": batch - 1}.get(what)
        if out[prefix] is None:
            out[prefix] = drawn.pop()
    return out


def check(run) -> list:
    """``drivers/batch.py``'s check frame, one frame a named scene."""
    (whole,) = _batch.check(run)
    per = run.n // run.conf["scene"]["batch"]
    frames = []
    for prefix, k in scenes_checked(run).items():
        rows = slice(k * per, (k + 1) * per)
        frames.append({"prefix": prefix, "mouse": None,
                       "start": {f: v[rows] for f, v in whole["start"].items()},
                       "got": {f: v[rows] for f, v in whole["got"].items()}})
    return frames
