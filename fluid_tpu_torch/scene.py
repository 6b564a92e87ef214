"""Scene construction (PyTorch port of ``fluid_tpu/scene.py``).

Dam-break seeding like the reference's ``main`` (``2d_multi.rs:502-512`` /
``3d_multi.rs:525-536``): unit-mass particles uniform in ``[16, 48]^2``
(2D) or ``[16, 32]^3`` (3D), at rest.  Randomness comes from an explicit
``torch.Generator``; its stream differs from ``jax.random``'s, so tests that
compare the two packages build their inputs in numpy.  The particles land on
``device``; None means ``default_device()``, the card (a CPU generator keeps
a seed's draw the same on every host, and the draw is then moved).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .config import Config, default_2d, default_3d
from .domain import Domain, make_domain
from .state import ParticleState
from .utils.platform import resolve_device

SEED_BOX_2D = ((16.0, 16.0), (48.0, 48.0))
SEED_BOX_3D = ((16.0, 16.0, 16.0), (32.0, 32.0, 32.0))
REFERENCE_N = 4096


def uniform_box(gen: torch.Generator, n: int, lo, hi, device=None) -> torch.Tensor:
    """[n, D] float32 positions uniform in the box ``[lo, hi)``, drawn on
    the generator's device and moved to ``device`` (None: the card)."""
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=gen.device)
    hi_t = torch.as_tensor(hi, dtype=torch.float32, device=gen.device)
    u = torch.rand((n, len(lo)), generator=gen, dtype=torch.float32, device=gen.device)
    return (lo_t + u * (hi_t - lo_t)).to(resolve_device(device))


def dam_break(gen: torch.Generator, cfg: Config, n: int = REFERENCE_N,
              box: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None,
              device=None) -> Tuple[ParticleState, Domain]:
    """Uniform-random block of fluid; returns particles and the domain (the
    ``set_rect`` analog, ``2d_multi.rs:513``)."""
    if box is None:
        box = SEED_BOX_2D if cfg.dim == 2 else SEED_BOX_3D
    pos = uniform_box(gen, n, box[0], box[1], device)
    return ParticleState.create(pos, device=pos.device), make_domain(cfg)


def scaled_dam_break(gen: torch.Generator, n: int, dim: int = 3, device=None):
    """A dam of ``n`` particles at rest density in a box scaled to fit it,
    the construction of ``bench.py`` (``_make_scene``, :64-74): side
    ``(n / rho0)^(1/D)``, world ``ceil(1.15 side)``, a 4-cell halo, the fluid
    box centred.  Returns (cfg, particles, domain)."""
    base = default_2d() if dim == 2 else default_3d()
    side = (n / base.rest_density) ** (1.0 / dim)
    world = math.ceil(side * 1.15)
    cfg = base.replace(boundary_clip=((0.0,) * dim, (float(world),) * dim))
    lo = (world - side) / 2
    pos = uniform_box(gen, n, (lo,) * dim, (lo + side,) * dim, device)
    return cfg, ParticleState.create(pos, device=pos.device), make_domain(cfg, halo_cells=4)


def reference_scene_2d(seed: int = 0, n: int = REFERENCE_N, device=None):
    """The reference 2D app scene (config, particles, domain)."""
    cfg = default_2d()
    p, dom = dam_break(torch.Generator().manual_seed(seed), cfg, n, device=device)
    return cfg, p, dom


def reference_scene_3d(seed: int = 0, n: int = REFERENCE_N, device=None):
    """The reference 3D app scene (config, particles, domain)."""
    cfg = default_3d()
    p, dom = dam_break(torch.Generator().manual_seed(seed), cfg, n, device=device)
    return cfg, p, dom
