"""PyTorch port, ``ops/tiling.py`` against ``fluid_tpu.ops.tiling`` on the
same numpy blocks and grids, at 1e-6 (the cases of tests/test_tiling.py,
1D to 3D tile shapes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_tpu.ops import tiling as jtiling
from fluid_tpu_torch.ops import tiling as ttiling

# one XLA program per case, not one per eager JAX op
J_ASSEMBLE = jax.jit(jtiling.assemble, static_argnums=(1, 2))
J_EXTRACT = jax.jit(jtiling.extract, static_argnums=(1, 2))
J_HALO_MASKED = jax.jit(
    lambda b, tshape, T, mask_shape: (jtiling.halo_sum(b, tshape, T)
                                      * jtiling.edge_mask(tshape, T).reshape(mask_shape)),
    static_argnums=(1, 2, 3))

CASES = [((3,), 4, ()), ((3, 2), 4, ()), ((3, 2), 4, (2,)), ((2, 2, 2), 4, (3,)),
         ((2, 3), 2, ()), ((4,), 4, (2,))]


def _blocks(tshape, T, chan, seed):
    rng = np.random.default_rng(seed)
    E = T + 2
    return rng.normal(size=(int(np.prod(tshape)), *(E,) * len(tshape), *chan)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("tshape,T,chan", CASES)
def test_assemble_matches_jax(tshape, T, chan):
    b = _blocks(tshape, T, chan, 0)
    _close(ttiling.assemble(torch.as_tensor(b), tshape, T), J_ASSEMBLE(jnp.asarray(b), tshape, T))


@pytest.mark.parametrize("tshape,T,chan", CASES)
def test_extract_matches_jax(tshape, T, chan):
    rng = np.random.default_rng(1)
    grid = rng.normal(size=tuple(t * T for t in tshape) + chan).astype(np.float32)
    _close(ttiling.extract(torch.as_tensor(grid), tshape, T), J_EXTRACT(jnp.asarray(grid), tshape, T))


@pytest.mark.parametrize("tshape,T,chan", CASES)
def test_halo_sum_times_edge_mask_matches_jax(tshape, T, chan):
    """halo_sum x edge_mask equals JAX's, and equals the dense round trip
    extract(assemble(blocks)) (the identity the backend relies on)."""
    b = _blocks(tshape, T, chan, 3)
    mask_shape = (-1,) + (T + 2,) * len(tshape) + (1,) * len(chan)
    got = ttiling.halo_sum(torch.as_tensor(b), tshape, T) * ttiling.edge_mask(tshape, T).reshape(mask_shape)
    want = J_HALO_MASKED(jnp.asarray(b), tshape, T, mask_shape)
    _close(got, want)
    tb = torch.as_tensor(b)
    trip = ttiling.extract(ttiling.assemble(tb, tshape, T), tshape, T)
    np.testing.assert_allclose(got.numpy(), trip.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tshape,T", [((3,), 4), ((3, 2), 4), ((2, 3), 2), ((2, 2, 2), 4), ((5, 1, 3), 4)])
def test_edge_mask_matches_jax(tshape, T):
    got = ttiling.edge_mask(tshape, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtiling.edge_mask(tshape, T)))
    assert got.dtype == torch.float32 and 0.0 < float(got.mean()) < 1.0


def test_assemble_extract_adjoint():
    """<assemble(B), G> == <B, extract(G)>: the two are transposes."""
    rng = np.random.default_rng(2)
    tshape, T, E = (3, 2), 4, 6
    B = torch.as_tensor(rng.normal(size=(6, E, E)).astype(np.float32))
    G = torch.as_tensor(rng.normal(size=(12, 8)).astype(np.float32))
    lhs = float((ttiling.assemble(B, tshape, T) * G).sum())
    rhs = float((B * ttiling.extract(G, tshape, T)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
