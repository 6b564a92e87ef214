"""Transfer backends of the PyTorch port: ``transfer`` (dense reference) and
``stream_transfer`` (tile-binned stream; kernels in ``stream_kernels``)."""

from .bspline import quadratic_weights, stencil_offsets, stencil_weights
from .eos import tait_pressure, stress_tensor
from .transfer import p2g_1, p2g_2, grid_update, g2p

__all__ = [
    "quadratic_weights",
    "stencil_offsets",
    "stencil_weights",
    "tait_pressure",
    "stress_tensor",
    "p2g_1",
    "p2g_2",
    "grid_update",
    "g2p",
]
