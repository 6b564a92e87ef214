"""PyTorch port, the micro-benchmark window contractions (M3
``window_deposit``, M4 ``window_gather``) against the Pallas kernels of
``bench/micro_sep.py`` (``make_dep``: onewindow, sep3, sepsel) and
``bench/micro_zfac.py`` (dep_cur / dep_z, rho_cur / rho_z, g2p_cur /
g2p_z), run in interpret mode on the CPU.

Both packages get the same numpy arrays; the port runs its plain versions
(CPU tensors).  Tolerance: max |d| <= 1e-5 x max |JAX| (a contraction,
summed in another order).  Both JAX forms of each micro_zfac function go
against each of the port's.  Nothing in ``bench/`` is edited:
``pl.pallas_call`` is patched to interpret mode and ``micro_zfac.NG`` to 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu_torch.micro import micro_sep, micro_zfac
from fluid_tpu_torch.ops import micro_kernels as mk

from .bench_scripts import interpret_pallas, load

torch.set_num_threads(1)

NG = 4
GL = 1024
_CACHE = {}


@pytest.fixture
def interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{what}: max|d| {err} > 1e-5 * {scale}"


def _zfac_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    wx, wy, wz = (rng.uniform(size=(NG, 8, GL)).astype(f) for _ in range(3))
    U = rng.normal(size=(NG, 12, GL)).astype(f)
    m = rng.uniform(size=(NG, 32, 128)).astype(f)
    B = rng.normal(size=(NG, 16, 512)).astype(f)
    return wx, wy, wz, U, m, B


def _zfac_jax(monkeypatch, name, form):
    """The JAX script's output of ``name`` ("dep", "rho", "g2p") in ``form``
    ("cur", "z") at NG groups, computed once per session."""
    if (name, form) not in _CACHE:
        jz = load("micro_zfac")
        monkeypatch.setattr(jz, "NG", NG)
        body = getattr(jz, f"{name}_{form}_kernel")
        rows, width = {"dep": (jz.G * jz.R * jz.S1, 128), "rho": (8, jz.GL),
                       "g2p": (16, jz.GL)}[name]
        ins = [jnp.asarray(a) for a in _zfac_inputs()]
        _CACHE[(name, form)] = np.asarray(jz._mk(body, rows, width)(*ins))
    return _CACHE[(name, form)]


PORT = {("dep", "cur"): micro_zfac.dep_cur, ("dep", "z"): micro_zfac.dep_z,
        ("rho", "cur"): micro_zfac.rho_cur, ("rho", "z"): micro_zfac.rho_z,
        ("g2p", "cur"): micro_zfac.g2p_cur, ("g2p", "z"): micro_zfac.g2p_z}


@pytest.mark.parametrize("jax_form", ["cur", "z"])
@pytest.mark.parametrize("port_form", ["cur", "z"])
@pytest.mark.parametrize("name", ["dep", "rho", "g2p"])
def test_zfac_matches_jax(interpret, monkeypatch, name, port_form, jax_form):
    want = _zfac_jax(monkeypatch, name, jax_form)
    got = PORT[(name, port_form)](*(torch.from_numpy(a) for a in _zfac_inputs()))
    assert got.shape == want.shape
    _close(got.numpy(), want, f"port {name}_{port_form} vs JAX {name}_{jax_form}")


def test_zfac_rho_rows_equal():
    """rho's eight output rows hold one value."""
    got = micro_zfac.rho_z(*(torch.from_numpy(a) for a in _zfac_inputs(1)))
    assert torch.equal(got, got[:, :1].expand_as(got))


@pytest.mark.parametrize("mode", ["onewindow", "sep3", "sepsel"])
def test_sep_make_dep_matches_jax(interpret, mode):
    js = load("micro_sep")
    rng = np.random.default_rng(5)
    s = rng.uniform(size=(NG, 24, GL)).astype(np.float32)
    wx = rng.uniform(size=(NG, 8, GL)).astype(np.float32)
    want = np.asarray(js.make_dep(NG, mode, pb=2)(jnp.asarray(s), jnp.asarray(wx)))
    got = micro_sep.make_dep(NG, mode, pb=2)(torch.from_numpy(s), torch.from_numpy(wx))
    assert got.shape == want.shape == (NG, 128, 128)
    _close(got.numpy(), want, mode)


def test_sep_modes_are_two_functions():
    """sep3 and sepsel are one function; onewindow (no partner rows) another."""
    s, wx = micro_sep.synth(2, seed=3, device="cpu")
    one, sep3, sepsel = (micro_sep.make_dep(2, m)(s, wx) for m in ("onewindow", "sep3", "sepsel"))
    assert torch.equal(sep3, sepsel)
    assert not torch.allclose(one, sep3)


def test_plain_versions_walk_group_chunks(monkeypatch):
    """The plain versions give the same result in chunks of groups as in one."""
    ins = [torch.from_numpy(a) for a in _zfac_inputs(2)]
    whole = [f(*ins) for f in PORT.values()]
    monkeypatch.setattr(mk, "PLAIN_CHUNK", 3)
    for f, w in zip(PORT.values(), whole):
        assert torch.equal(f(*ins), w)


def test_window_wrappers_check_their_arguments():
    wx, wy, wz, U, m, B = (torch.from_numpy(a) for a in _zfac_inputs())
    with pytest.raises(ValueError, match="form"):
        mk.window_deposit("tall", U, wx, wy, wz)
    with pytest.raises(ValueError, match="part"):
        mk.window_deposit("sep", U, wx, wy, wz)
    with pytest.raises(ValueError, match="shape"):
        mk.window_deposit("wide", U[:, :8], wx, wy, wz)
    with pytest.raises(ValueError, match="strides"):
        mk.window_deposit("wide", U, wx.transpose(1, 2).contiguous().transpose(1, 2), wy, wz)
    with pytest.raises(ValueError, match="shape"):
        mk.window_gather("rho", "wide", B, wx, wy, wz)
    with pytest.raises(ValueError, match="kind"):
        mk.window_gather("p2g", "wide", m, wx, wy, wz)
    assert mk.LAUNCHES == {name: 0 for name in mk.KERNELS}
