"""Shared by the stream-probe tests (``test_torch_micro_b1_*.py``):
``bench/micro_kernels.py`` in interpret mode, the ``synth*`` data of both
packages at A = 20 tiles, and the JAX outputs, each computed once per
session.

``_case_kernel`` passes ``interpret=False`` itself, overriding the patched
``pl.pallas_call``, so it is patched to ``interpret=True`` as well; nothing
in ``bench/`` is edited.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from fluid_tpu_torch.micro import micro_kernels as pm

from .bench_scripts import interpret_pallas, load

N = 1280  # A = 20 tiles (16 at G = 16)
SYNTHS = {"rows": ("synth", {}), "slot": ("synth_slotmajor", {}), "blocks": ("synth_blocks", {}),
          "g8": ("synth_grouped", {"G": 8}), "g16": ("synth_grouped", {"G": 16})}
_DATA = {}
_JAX = {}


def script(monkeypatch):
    """``bench/micro_kernels.py`` with every Pallas call in interpret mode,
    for one test."""
    interpret_pallas(monkeypatch)
    mod = load("micro_kernels")
    monkeypatch.setattr(mod, "_case_kernel", functools.partial(mod._case_kernel, interpret=True))
    return mod


def data(jm, layout):
    """(the script's data, the port's data on the CPU) of ``layout``."""
    if layout not in _DATA:
        fn, kw = SYNTHS[layout]
        _DATA[layout] = (getattr(jm, fn)(N, **kw), getattr(pm, fn)(N, device="cpu", **kw))
    return _DATA[layout]


def run(jm, key, layout, make, extra=()):
    """The script's output (once per session, under ``key``) and the port's
    of ``make(module, data)`` on the layout's arrays and ``extra`` numpy
    inputs."""
    jd, td = data(jm, layout)
    keys = ("act_start", "act_count", "tid", "stream") if layout == "rows" else ("count", "stream")
    if key not in _JAX:
        _JAX[key] = np.asarray(make(jm, jd)(*(jd[k] for k in keys),
                                            *(jnp.asarray(x) for x in extra)))
    return _JAX[key], make(pm, td)(*(td[k] for k in keys),
                                   *(torch.from_numpy(x) for x in extra)).numpy()


def check(got, want, written, axis, bounds=None):
    """Per channel along ``axis``: max|d| <= 1e-5 x max|JAX| (or
    ``bounds[c]``) where ``written``; zero elsewhere (the script leaves those
    entries unwritten)."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[~written], 0.0)
    for c in range(want.shape[axis]):
        w = np.take(want, c, axis)[np.take(written, c, axis)]
        g = np.take(got, c, axis)[np.take(written, c, axis)]
        assert np.all(np.isfinite(w))
        bound = 1e-5 * np.abs(w).max() if bounds is None or c not in bounds else bounds[c]
        err = np.abs(g - w).max()
        assert err <= bound, f"channel {c}: max|d| {err} > {bound}"


def first_tiles(shape, tiles):
    """A mask of ``shape`` true on its first ``tiles`` entries of axis 0."""
    mask = np.zeros(shape, bool)
    mask[:tiles] = True
    return mask
