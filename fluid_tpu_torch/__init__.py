"""fluid-tpu on PyTorch and CUDA: the MLS-MPM/APIC fluid, ported from JAX.

The JAX package ``fluid_tpu`` is the reference this package is tested
against; this one imports ``torch`` and never ``jax``.  On a CUDA device the
``Session`` runs the stream backend, whose substep stages are hand-written
Hopper kernels (``csrc/stream_kernels.cu``); on the CPU the same code runs
the kernels' plain PyTorch versions.

Quick start::

    import torch
    from fluid_tpu_torch import scene
    from fluid_tpu_torch.session import Session

    cfg, p, dom = scene.reference_scene_3d(seed=0)
    sess = Session(cfg, dom, p, device="cuda")   # stream backend on CUDA
    sess.run(10)
    print(sess.render((64.0, 64.0), (80, 40)))
"""

import torch

from .config import Config, default_2d, default_3d
from .domain import Domain, make_domain
from .state import GridState, ParticleState
from . import checkpoint, diagnostics, ops, render, scene, step

__version__ = "0.1.0"

# Float32 everywhere; a TF32 product fails the golden trajectories at ~1e-3.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "Config", "default_2d", "default_3d", "Domain", "make_domain",
    "GridState", "ParticleState", "checkpoint", "diagnostics", "ops", "render", "scene",
    "step",
]
