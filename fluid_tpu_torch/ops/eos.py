"""Tait equation of state and stress (PyTorch port of ``fluid_tpu/ops/eos.py``).

``p = max(floor, k((rho/rho0)^gamma - 1))`` (``2d_multi.rs:211-214``) and
``sigma = -p I + mu (C + C^T)`` (``2d_multi.rs:216-218``).
"""

from __future__ import annotations

import torch


def tait_pressure(density: torch.Tensor, rest_density: float, stiffness: float,
                  power: float, floor: float) -> torch.Tensor:
    return torch.clamp_min(
        stiffness * ((density / rest_density) ** power - 1.0), floor
    )


def stress_tensor(C: torch.Tensor, pressure: torch.Tensor,
                  dynamic_viscosity: float) -> torch.Tensor:
    """[..., D, D] stress from [..., D, D] C and [...] pressure."""
    dim = C.shape[-1]
    strain = C + C.transpose(-1, -2)
    eye = torch.eye(dim, dtype=C.dtype, device=C.device)
    return -pressure[..., None, None] * eye + dynamic_viscosity * strain
