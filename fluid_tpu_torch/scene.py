"""Scene construction (PyTorch port of ``fluid_tpu/scene.py``).

Dam-break seeding like the reference's ``main`` (``2d_multi.rs:502-512`` /
``3d_multi.rs:525-536``): unit-mass particles uniform in ``[16, 48]^2``
(2D) or ``[16, 32]^3`` (3D), at rest.  Randomness comes from an explicit
``torch.Generator``; its stream differs from ``jax.random``'s, so tests that
compare the two packages build their inputs in numpy.  The particles land on
``device``; None means ``default_device()``, the card (a CPU generator keeps
a seed's draw the same on every host, and the draw is then moved).

``batched_dam_break`` builds a stack of scenes and ``pack_scenes`` lays it
out as one domain for the stream backend, as ``fluid_tpu/scene.py`` does;
its ``PackedDomain`` states the scene count and stride.  A ``Session`` on
that domain takes the stack as ``batch_rows``: every scene in its own
coordinates, so each computes at float32 where it is.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .config import Config, default_2d, default_3d
from .domain import Domain, PackedDomain, make_domain
from .state import FIELDS, ParticleState
from .utils.platform import resolve_device

SEED_BOX_2D = ((16.0, 16.0), (48.0, 48.0))
SEED_BOX_3D = ((16.0, 16.0, 16.0), (32.0, 32.0, 32.0))
REFERENCE_N = 4096


def uniform_box(gen: torch.Generator, n, lo, hi, device=None) -> torch.Tensor:
    """[n, D] float32 positions uniform in the box ``[lo, hi)`` ([*n, D]
    for a tuple ``n``), drawn on the generator's device and moved to
    ``device`` (None: the card)."""
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=gen.device)
    hi_t = torch.as_tensor(hi, dtype=torch.float32, device=gen.device)
    lead = (n,) if isinstance(n, int) else tuple(n)
    u = torch.rand((*lead, len(lo)), generator=gen, dtype=torch.float32, device=gen.device)
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


def batched_dam_break(gen: torch.Generator, cfg: Config, batch: int, n: int = REFERENCE_N,
                      jitter: float = 8.0, device=None) -> Tuple[ParticleState, Domain]:
    """A [batch, N, D] stack of dam-break scenes (``BASELINE.json``'s
    fifth configuration: 64 randomized 3D scenes).  Each scene's seed box
    moves by a random shift of up to ``jitter`` world units per axis, kept
    inside the walls."""
    box = SEED_BOX_2D if cfg.dim == 2 else SEED_BOX_3D
    D = cfg.dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    lo, hi = torch.tensor(box[0], **f32), torch.tensor(box[1], **f32)
    clip_lo, clip_hi = (torch.tensor(b, **f32) for b in cfg.boundary_clip)
    shift = uniform_box(gen, batch, (-jitter,) * D, (jitter,) * D, gen.device)
    shift = torch.clamp(shift, clip_lo - lo, clip_hi - hi)
    pos = uniform_box(gen, (batch, n), box[0], box[1], gen.device) + shift[:, None, :]
    return ParticleState.create(pos, device=resolve_device(device)), make_domain(cfg)


def add_particles(state: ParticleState, pos, vel=None, C=None, mass=None) -> ParticleState:
    """Append particles to a scene (the ``add_particle`` analog,
    ``2d_multi.rs:104-108``); returns a new state on the scene's device."""
    extra = ParticleState.create(pos, vel=vel, C=C, mass=mass, device=state.device)
    return ParticleState(**{f: torch.cat([getattr(state, f), getattr(extra, f)])
                            for f in FIELDS})


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


# ---------------------------------------------------------------------------
# Scene packing: a batch of scenes as one domain for the stream backend
# ---------------------------------------------------------------------------


def pack_scenes(state: ParticleState, cfg: Config,
                halo_cells: int = 4) -> Tuple[ParticleState, PackedDomain, float]:
    """Lay a [batch, N, D] stack of scenes side by side along x in one
    domain: scene k owns the grid columns ``[k stride, (k + 1) stride)``,
    the world ``[k stride, k stride + world]`` and ``halo_cells`` on each
    side, so neighbouring grids are ``2 halo_cells`` unused cells apart and
    scenes never interact.  The packed particles are ``fluid_tpu``'s: x of
    scene k moved by ``k * stride``.  The stream ``Session`` takes the
    stack in scene coordinates instead (``batch_rows``) and keeps each
    scene inside its own walls.

    Returns (packed particles [batch * N], packed domain, stride)."""
    if state.pos.ndim != 3:
        raise ValueError("pack_scenes expects a [batch, N, D] particle stack")
    batch, n, D = state.pos.shape
    lo, hi = cfg.boundary_clip
    if any(abs(v) > 1e-6 for v in lo):
        raise ValueError("pack_scenes assumes boundary_clip starting at 0")
    stride = float(-(-int(math.ceil(hi[0]) + 2 * halo_cells) // 8) * 8)

    offsets = torch.arange(batch, dtype=torch.float32, device=state.device) * stride
    pos = state.pos.clone()
    pos[..., 0] += offsets[:, None]
    fields = {f: getattr(state, f) for f in FIELDS} | {"pos": pos}
    packed = ParticleState(**{f: a.reshape(batch * n, *a.shape[2:]) for f, a in fields.items()})

    shape = (batch * int(stride),) + tuple(
        -(-(int(math.ceil(hi[d])) + 2 * halo_cells) // 8) * 8 for d in range(1, D)
    )
    dom = PackedDomain(origin=(-halo_cells,) * D, shape=shape,
                       a_rect=((0,) * D, (1,) * D), p_rect=((-1,) * D, (2,) * D),
                       scenes=batch, scene_stride=int(stride))
    return packed, dom, stride


def batch_rows(state: ParticleState) -> ParticleState:
    """A [batch, N, ...] stack as [batch * N] rows, scene-major, each
    particle in its own scene's coordinates: what a ``Session`` on
    ``pack_scenes``' domain takes and what its ``particles()`` returns."""
    if state.pos.ndim != 3:
        raise ValueError("batch_rows expects a [batch, N, D] particle stack")
    batch, n = state.pos.shape[:2]
    return ParticleState(**{f: getattr(state, f).reshape(batch * n, *getattr(state, f).shape[2:])
                            for f in FIELDS})


def unpack_scenes(packed: ParticleState, batch: int, n: int, stride: float) -> ParticleState:
    """Inverse of ``pack_scenes``: [batch, N, ...] with each scene's own x."""
    fields = {f: getattr(packed, f).reshape(batch, n, *getattr(packed, f).shape[1:])
              for f in FIELDS}
    offsets = torch.arange(batch, dtype=torch.float32, device=packed.device) * stride
    fields["pos"] = fields["pos"].clone()
    fields["pos"][..., 0] -= offsets[:, None]
    return ParticleState(**fields)
