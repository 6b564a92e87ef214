"""PyTorch port, the stream probes of ``bench/micro_kernels.py``: the fills
(M5 ``stage_fill``: ``case_dma_only``, ``case_nodma``, ``case_dma_tb``,
``case_tb2_dma``, ``_tb3_dma``, ``_tb4_dma``) and the window contractions
(M6 ``window_contract``: ``case_window_build``, ``case_matmul``) against
the script's Pallas kernels in interpret mode on the CPU.

Both packages take the same ``synth*`` arrays (the port's are bit-equal to
the script's from the same seed); the port runs its plain versions (CPU
tensors).  Tolerance: fills bit-equal; contractions max|d| <= 1e-5 x
max|JAX| for each output channel.  The entries the script's grid never
writes (the A % TB tail) must be zero in the port.  A = 20 tiles (n =
1280): TB = 8 leaves a 4-tile tail, and TB = 4's last program starts at
row 1024 of 1408, so its 512 rows are clamped to start at 896.

The script runs in interpret mode through ``tests/micro_b1.py``.
"""

import numpy as np
import pytest
import torch

from fluid_tpu_torch.micro import micro_kernels as pm
from fluid_tpu_torch.ops import micro_stream as ms

from .micro_b1 import N, SYNTHS, data, run, script

torch.set_num_threads(1)


@pytest.fixture
def jm(monkeypatch):
    return script(monkeypatch)


@pytest.mark.parametrize("layout", list(SYNTHS))
def test_synth_bit_equal_to_jax(jm, layout):
    jd, td = data(jm, layout)
    for k, v in td.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jd[k]), err_msg=k)
        else:
            assert v == jd[k], k


# (layout, case, written tiles of A = 20 or groups, the case's maker)
FILLS = {
    "dma_only_E6": ("rows", 20, lambda m, d: m.case_dma_only(d, E=6)),
    "nodma_E6": ("rows", 20, lambda m, d: m.case_nodma(d, E=6)),
    "dma_tb4_clamped": ("rows", 20, lambda m, d: m.case_dma_tb(d, TB=4)),
    "dma_tb8_tail": ("rows", 16, lambda m, d: m.case_dma_tb(d, TB=8)),
    "tb2_dma_tb8": ("slot", 16, lambda m, d: m.case_tb2_dma(d, TB=8)),
    "tb2_dma_tb4_E8": ("slot", 20, lambda m, d: m.case_tb2_dma(d, TB=4, E=8)),
    "tb3_dma_tb8": ("blocks", 16, lambda m, d: m._tb3_dma(d, TB=8)),
    "tb4_dma_G8": ("g8", 2, lambda m, d: m._tb4_dma(d)),
    "tb4_dma_G16": ("g16", 1, lambda m, d: m._tb4_dma(d)),
}


@pytest.mark.parametrize("name", list(FILLS))
def test_fill_matches_jax(jm, name):
    layout, written, make = FILLS[name]
    want, got = run(jm, name, layout, make)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:written], want[:written])
    np.testing.assert_array_equal(got[written:], 0.0)


def test_clamped_program_reads_the_stream_end():
    """TB = 4's last program (tiles 16-19) reads rows [896, 1408), the last
    512 of the stream: tile 16 + j's value is row 896 + 128 j's x."""
    d = pm.synth(N, device="cpu")
    got = pm.case_dma_tb(d, TB=4)(d["act_start"], d["act_count"], d["tid"], d["stream"])
    want = d["stream"][896 + 128 * torch.arange(4), 0]
    assert torch.equal(got[16:, 0, 0], want)
    assert torch.equal(got[15, 0, 0], d["stream"][(12 * 64) + 3 * 128, 0])


CONTRACTIONS = {
    "window_E6": lambda m, d: m.case_window_build(d, E=6),
    "window_E8": lambda m, d: m.case_window_build(d, E=8),
    "mm_E6_N16": lambda m, d: m.case_matmul(d, E=6, N=16),
    "mm_E6_N128": lambda m, d: m.case_matmul(d, E=6, N=128),
    "mm_E8_N16": lambda m, d: m.case_matmul(d, E=8, N=16),
}


@pytest.mark.parametrize("name", list(CONTRACTIONS))
def test_window_contract_matches_jax(jm, name):
    want, got = run(jm, name, "rows", CONTRACTIONS[name])
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=(0, 1))
    err = np.abs(got - want).max(axis=(0, 1))
    assert np.all(err <= 1e-5 * scale), (err, scale)
    if name.startswith("window"):  # the row sums in 8 equal columns
        assert np.array_equal(got, np.broadcast_to(got[:, :, :1], got.shape))


def test_precisions_are_one_function():
    """"high" and "default" run the float32 function of "highest"."""
    d = pm.synth(N, device="cpu")
    args = (d["act_start"], d["act_count"], d["tid"], d["stream"])
    outs = [pm.case_matmul(d, E=6, N=16, prec=p)(*args) for p in pm.PRECISIONS]
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="prec"):
        pm.case_matmul(d, prec="bf16")


def test_plain_versions_walk_tile_chunks(monkeypatch):
    """The plain versions give the same result in chunks of tiles as in one."""
    d = pm.synth(N, device="cpu")
    args = (d["act_start"], d["act_count"], d["tid"], d["stream"])
    cases = [pm.case_matmul(d, E=8, N=16), pm.case_deposit_onewindow_tb(d, TB=8, E=6)]
    whole = [f(*args) for f in cases]
    monkeypatch.setattr(ms, "PLAIN_TILES", 3)
    for f, w in zip(cases, whole):
        assert torch.equal(f(*args), w)


def test_stream_probe_wrappers_check_their_arguments():
    d = pm.synth(N, device="cpu")
    args = (d["act_start"], d["act_count"], d["tid"], d["stream"])
    with pytest.raises(ValueError, match="the case was made for"):
        pm.case_dma_only(d)(*args[:3], d["stream"][:-1])
    with pytest.raises(ValueError, match="lanes"):
        pm.case_matmul(d, N=129)
    with pytest.raises(ValueError, match="int32"):
        pm.case_dma_only(d)(d["act_start"].long(), *args[1:])
    with pytest.raises(ValueError, match="form"):
        ms.p2g1_deposit(d["stream"], ms.slot_major(20, 128), d["act_count"], None,
                        ms.Window(6, 4, (4, 4, 4), 128), form="twowindow", A=20, written=20,
                        out_view=ms.blocks(216, 4), out_shape=(20, 216, 4))
    with pytest.raises(ValueError, match="rows do not fit"):
        ms.row_major(d["act_start"], 100, 128, 128, tb=1)
    assert ms.LAUNCHES == {name: 0 for name in ms.KERNELS}  # plain versions launch nothing
