"""PyTorch port, the stream probes' p2g1 deposits (M7 ``p2g1_deposit``:
``case_deposit_current``, ``case_deposit_onewindow``,
``case_deposit_onewindow_tb``, ``case_tb2_deposit``, ``_tb3_deposit``,
``_tb4_deposit``) over the four stream layouts of
``bench/micro_kernels.py``, against the script's Pallas kernels in
interpret mode on the CPU (helpers: ``tests/micro_b1.py``).

Both packages take the same ``synth*`` arrays (``test_torch_micro_b1_probes``
holds the port's bit-equal to the script's); the port runs its plain
versions (CPU tensors).  A = 20 tiles (16 at G = 16): TB = 8 leaves a
4-tile tail, TB = 4's last row-major program is clamped into the stream.
Tolerance, for each output channel: max|d| <= 1e-5 x max|JAX| over the
entries the script writes; the entries it never writes (the A % TB tail,
tb4's lanes past E^3) must be zero in the port.
"""

import numpy as np
import pytest
import torch

from fluid_tpu_torch.micro import micro_kernels as pm

from .micro_b1 import N, check, first_tiles, run, script

torch.set_num_threads(1)


@pytest.fixture
def jm(monkeypatch):
    return script(monkeypatch)


# name: (layout, written tiles, maker); TB = 8 once for the tail, TB = 4
# elsewhere (the script's unrolled programs trace in half the time)
DEPOSITS = {
    "current_E6": ("rows", 20, lambda m, d: m.case_deposit_current(d, E=6)),
    "current_E8": ("rows", 20, lambda m, d: m.case_deposit_current(d, E=8)),
    "onewindow_E6": ("rows", 20, lambda m, d: m.case_deposit_onewindow(d, E=6)),
    "onewindow_E8": ("rows", 20, lambda m, d: m.case_deposit_onewindow(d, E=8)),
    "tb4_E6_clamped": ("rows", 20, lambda m, d: m.case_deposit_onewindow_tb(d, TB=4, E=6)),
    "tb8_E8_tail": ("rows", 16, lambda m, d: m.case_deposit_onewindow_tb(d, TB=8, E=8)),
    "tb2_kernel_E6": ("slot", 20, lambda m, d: m.case_tb2_deposit(d, TB=4, E=6)),
    "tb2_xla_E6": ("slot", 20, lambda m, d: m.case_tb2_deposit(d, TB=4, E=6, fixup="xla")),
    "tb2_kernel_E8": ("slot", 20, lambda m, d: m.case_tb2_deposit(d, TB=4, E=8)),
    "tb3_E6": ("blocks", 20, lambda m, d: m._tb3_deposit(d, TB=4, E=6)),
    "tb3_E8": ("blocks", 20, lambda m, d: m._tb3_deposit(d, TB=4, E=8)),
}


@pytest.mark.parametrize("name", list(DEPOSITS))
def test_deposit_matches_jax(jm, name):
    layout, written, make = DEPOSITS[name]
    want, got = run(jm, f"deposit_{name}", layout, make)
    check(got, want, first_tiles(want.shape, written), axis=2)


@pytest.mark.parametrize("G,E,mode", [(8, 8, "abt"), (16, 6, "tr")])
def test_tb4_deposit_matches_jax(jm, G, E, mode):
    """[NG, 4, G*EP]: tile j's window at lanes [j*EP, j*EP + E^3); the
    lanes past E^3 are zero in the port (unwritten by the script).  The
    script's two modes are one function: the port's one form goes against
    each."""
    want, got = run(jm, f"tb4_G{G}_E{E}_{mode}", f"g{G}",
                     lambda m, d: m._tb4_deposit(d, E=E, mode=mode))
    EP = 256 if E == 6 else 512
    written = np.zeros(want.shape, bool)
    for j in range(G):
        written[:, :, j * EP: j * EP + E**3] = True
    check(got, want, written, axis=1)


def test_onewindow_is_current_shifted_at_e8():
    """At E = 6 the two clip rules give one block; at E = 8 the onewindow
    window is the current one shifted by E - T - 2 = 2 cells on each axis
    (each tile's valid particles lie in its own cells, so neither clip
    binds)."""
    d = pm.synth(N, device="cpu")
    args = (d["act_start"], d["act_count"], d["tid"], d["stream"])
    cur6, one6 = pm.case_deposit_current(d, E=6)(*args), pm.case_deposit_onewindow(d, E=6)(*args)
    torch.testing.assert_close(cur6, one6, rtol=0, atol=1e-5 * float(cur6.abs().max()))
    cur8, one8 = pm.case_deposit_current(d, E=8)(*args), pm.case_deposit_onewindow(d, E=8)(*args)
    e = torch.arange(512)
    inner = (e // 64 >= 2) & (e // 8 % 8 >= 2) & (e % 8 >= 2)
    torch.testing.assert_close(one8[:, inner], cur8[:, e[inner] - 2 * 64 - 2 * 8 - 2],
                               rtol=0, atol=1e-5 * float(cur8.abs().max()))
    assert torch.equal(one8[:, ~inner], torch.zeros_like(one8[:, ~inner]))
    assert not torch.allclose(one8, cur8)
