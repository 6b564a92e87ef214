"""PyTorch port, the stream probes' collects (M8 ``window_collect``:
``case_tb2_collect``, ``_tb3_collect``, ``_tb4_collect``) on the
slot-major, block and grouped layouts of ``bench/micro_kernels.py``,
against the script's Pallas kernels in interpret mode on the CPU
(helpers: ``tests/micro_b1.py``).

Both packages take the same ``synth*`` arrays and the same random v and
mass blocks (``run_tb2/3/4``'s draws); the port runs its plain versions
(CPU tensors).  A = 20 tiles: TB = 8 leaves a 4-tile tail, which must be
zero in the port.  Tolerance, for each output row: max|d| <= 1e-5 x
max|JAX| over the entries the script writes.  The pressure row prs =
max(-0.1, 10 (rho^4 - 1)) gets its own bound: with |d rho| <= delta =
1e-5 max|rho| (rho's row), |d prs| <= 10 |(rho + delta)^4 - rho^4| ~ 40
rho^3 delta <= 4e-4 max|rho|^4, four times rho's relative bound, since
max|prs| ~ 10 max|rho|^4.
"""

import numpy as np
import pytest
import torch

from fluid_tpu_torch.micro import micro_kernels as pm

from .micro_b1 import check, data, run, script

torch.set_num_threads(1)


@pytest.fixture
def jm(monkeypatch):
    return script(monkeypatch)


# name: (layout, E, TB (None: grouped), input shape)
COLLECTS = {
    "tb2_E6_tail": ("slot", 6, 8, "cell"),
    "tb2_E8": ("slot", 8, 4, "cell"),
    "tb3_E6": ("blocks", 6, 4, "channel"),
    "tb3_E8": ("blocks", 8, 4, "channel"),
    "tb4_G8_E6": ("g8", 6, None, "gblk"),
    "tb4_G8_E8": ("g8", 8, None, "gblk"),
}
COLLECT_FN = {"cell": "case_tb2_collect", "channel": "_tb3_collect"}


@pytest.mark.parametrize("name", list(COLLECTS))
def test_collect_matches_jax(jm, name):
    """tb2: out [18, A*cap], tb3: [A, 18, cap], tb4: [NG, 18, G*cap]; with
    TB = 8 tiles 16-19 are unwritten.  Inputs: the script's random v and
    mass blocks (``run_tb2/3/4``'s draws)."""
    layout, E, TB, shape = COLLECTS[name]
    td = data(jm, layout)[1]
    rng = np.random.default_rng(1)
    extra = tuple(x.numpy() for x in pm.collect_inputs(rng, td, E, shape))
    if TB is None:
        make = lambda m, d: m._tb4_collect(d, E=E)  # noqa: E731
    else:
        make = lambda m, d: getattr(m, COLLECT_FN[shape])(d, TB=TB, E=E)  # noqa: E731
    want, got = run(jm, f"collect_{name}", layout, make, extra)
    written = np.ones(want.shape, bool)
    if TB is not None:
        tiles = td["A"] // TB * TB
        if shape == "cell":
            written[:, tiles * td["cap"]:] = False
        else:
            written[tiles:] = False
    axis = 0 if shape == "cell" else 1
    rho = np.take(want, 15, axis)[np.take(written, 15, axis)]
    check(got, want, written, axis, bounds={16: 4e-4 * np.abs(rho).max() ** 4})
