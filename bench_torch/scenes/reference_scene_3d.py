"""The app's scene: ``scene.particles`` uniform in the reference's seed box
(``fluid_tpu_torch.scene.dam_break`` under the reference Config of the
configuration's dimension), drawn from one host generator seeded with the
run's seed."""

import torch


def build(conf: dict, seed: int, count: int, device) -> tuple:
    """(cfg, domain, [particles] * count), drawn one after another."""
    from fluid_tpu_torch import scene
    from fluid_tpu_torch.config import default_2d, default_3d

    cfg = default_2d() if conf["physics"]["dim"] == 2 else default_3d()
    gen = torch.Generator().manual_seed(seed)
    out = [scene.dam_break(gen, cfg, conf["scene"]["particles"], device=device)
           for _ in range(count)]
    return cfg, out[0][1], [p for p, _ in out]
