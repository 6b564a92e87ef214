"""Scalar diagnostics (PyTorch port of ``fluid_tpu/diagnostics.py``).

The reference's only observability is the ASCII render and the per-phase
timing lines (``2d_multi.rs:438-489``); these scalar metrics (speeds,
kinetic energy, density, pressure, momentum, centre of mass) are the cheap
extras.  ``metrics`` computes them on the particles' device with no host
read; ``format_metrics`` reads them for a one-line summary.
"""

from __future__ import annotations

from typing import Dict

import torch

from .state import ParticleState


def metrics(p: ParticleState) -> Dict[str, torch.Tensor]:
    """Per-frame scalar metrics, as tensors on ``p``'s device."""
    speed = torch.linalg.vector_norm(p.vel, dim=-1)
    mass_sum = p.mass.sum()
    return {
        "n": torch.tensor(p.n, device=p.device),
        "max_speed": speed.max(),
        "mean_speed": speed.mean(),
        "kinetic_energy": 0.5 * torch.sum(p.mass * speed * speed),
        "mean_density": p.density.mean(),
        "max_density": p.density.max(),
        "mean_pressure": p.pressure.mean(),
        "max_pressure": p.pressure.max(),
        "total_mass": mass_sum,
        "momentum": torch.sum(p.mass[:, None] * p.vel, dim=0),
        "center_of_mass": torch.sum(p.mass[:, None] * p.pos, dim=0) / mass_sum,
    }


def format_metrics(m) -> str:
    """One-line human-readable summary for the app overlay."""
    return (
        f"n={int(m['n'])} |v|max={float(m['max_speed']):.3f} "
        f"KE={float(m['kinetic_energy']):.2f} "
        f"rho={float(m['mean_density']):.3f} p={float(m['mean_pressure']):.3f}"
    )
