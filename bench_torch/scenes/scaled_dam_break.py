"""A dam of ``scene.particles`` at rest density in a box scaled to hold it
(``fluid_tpu_torch.scene.scaled_dam_break``), drawn on the card from one
generator seeded with the run's seed."""

import torch


def build(conf: dict, seed: int, count: int, device) -> tuple:
    """(cfg, domain, [particles] * count): ``count`` dams drawn one after
    another from the seed's generator (the first is the builder's dam of
    that seed)."""
    from fluid_tpu_torch import scene

    gen = torch.Generator(device=device).manual_seed(seed)
    out = [scene.scaled_dam_break(gen, conf["scene"]["particles"], dim=conf["physics"]["dim"],
                                  device=device) for _ in range(count)]
    return out[0][0], out[0][2], [p for _, p, _ in out]
