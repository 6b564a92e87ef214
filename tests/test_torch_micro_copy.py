"""PyTorch port, the micro-benchmark copies (M1 ``prefix_copy``, M2
``bulk_copy``) against the Pallas kernels of ``bench/micro_sep.py``
(``make_copy``), ``bench/micro_pb.py`` (``make_copy``) and
``bench/micro_dma.py`` (``make_pipelined``, ``make_manual``), run in
interpret mode on the CPU.

Both packages get the same numpy arrays; the port runs its plain versions
(CPU tensors).  Tolerance: bit-equal (a copy).  Nothing in ``bench/`` is
edited: ``pl.pallas_call`` is patched to interpret mode for each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu_torch.micro import micro_dma, micro_pb, micro_sep
from fluid_tpu_torch.ops import micro_kernels as mk

from .bench_scripts import interpret_pallas, load

torch.set_num_threads(1)

GL = 1024


@pytest.fixture
def bench(monkeypatch):
    """The loader of bench scripts, their Pallas calls in interpret mode."""
    interpret_pallas(monkeypatch)
    return load


def _stream(ng, seed=0, rows=24):
    return np.random.default_rng(seed).uniform(size=(ng, rows, GL)).astype(np.float32)


@pytest.mark.parametrize("pb", [2, 4])
@pytest.mark.parametrize("rows,lanes", [(64, 128), (32, 256), (16, 512), (8, 1024)])
def test_sep_make_copy_matches_jax(bench, rows, lanes, pb):
    js = bench("micro_sep")
    ng = 4
    s = _stream(ng)
    want = np.asarray(js.make_copy(ng, rows, lanes, pb)(jnp.asarray(s)))
    got = micro_sep.make_copy(ng, rows, lanes, pb)(torch.from_numpy(s))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pb,arb", [(2, False), (4, False), (8, False), (16, False), (4, True)])
def test_pb_make_copy_matches_jax(bench, pb, arb):
    jp = bench("micro_pb")
    ng = max(4, pb)
    s = _stream(ng, seed=1)
    want = np.asarray(jp.make_copy(ng, pb, arb)(jnp.asarray(s)))
    got = micro_pb.make_copy(ng, pb, arb)(torch.from_numpy(s))
    assert got.shape == (ng, 64, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pb", [2, 4])
def test_dma_make_pipelined_matches_jax(bench, pb):
    jd = bench("micro_dma")
    ng, rows, lanes = 4, 24, GL
    x = _stream(ng, seed=2)
    want = np.asarray(jd.make_pipelined(ng, rows, lanes, pb)(jnp.asarray(x)))
    got = micro_dma.make_pipelined(ng, rows, lanes, pb)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ng,chunk", [(8, 2), (8, 4)])
def test_dma_make_manual_matches_jax(bench, ng, chunk):
    """The hand-rolled double-buffered DMA (semaphores in interpret mode)
    against the bulk copy's plain version: both are the identity."""
    jd = bench("micro_dma")
    rows, lanes = 24, GL
    x = _stream(ng, seed=3)
    want = np.asarray(jd.make_manual(ng, rows, lanes, chunk)(jnp.asarray(x)))
    got = micro_dma.make_manual(ng, rows, lanes, chunk)(torch.from_numpy(x))
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(got.numpy(), want)


def test_copy_wrappers_check_their_arguments():
    s = torch.from_numpy(_stream(4))
    with pytest.raises(ValueError, match="whole number"):
        micro_sep.make_copy(4, 3, 100)
    with pytest.raises(ValueError, match="groups"):
        micro_sep.make_copy(8, 8, 1024)(s)
    with pytest.raises(ValueError, match="floats of a"):
        mk.prefix_copy(s, 32, 1024)
    with pytest.raises(ValueError, match="chunk"):
        mk.bulk_copy(s, 3)
    with pytest.raises(ValueError, match="contiguous"):
        mk.prefix_copy(s[:, :8], 8, 1024)
    with pytest.raises(ValueError, match="expected"):
        micro_dma.make_manual(4, 8, 1024, 2)(s)
    assert mk.LAUNCHES == {name: 0 for name in mk.KERNELS}  # plain versions launch nothing
