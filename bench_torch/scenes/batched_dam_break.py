"""A batch of ``scene.batch`` reference dams, each ``scene.particles`` in
the reference's seed box moved by up to ``scene.jitter`` per axis
(``fluid_tpu_torch.scene.batched_dam_break``), laid side by side along x in
one packed domain (``scene.pack_scenes``), drawn from one host generator
seeded with the run's seed.  The particles are the batch's rows one scene
after the other, each in its own scene's coordinates
(``scene.batch_rows``), as the program's ``Session`` takes them."""

import torch


def build(conf: dict, seed: int, count: int, device) -> tuple:
    """(cfg, packed domain, [rows] * count): ``count`` batches drawn one
    after another from the seed's generator."""
    from fluid_tpu_torch import scene
    from fluid_tpu_torch.config import default_2d, default_3d

    sc = conf["scene"]
    cfg = default_2d() if conf["physics"]["dim"] == 2 else default_3d()
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        stack, _ = scene.batched_dam_break(gen, cfg, sc["batch"], sc["particles"],
                                           jitter=sc["jitter"], device=device)
        _, dom, _ = scene.pack_scenes(stack, cfg)
        if getattr(dom, "scenes", 1) != sc["batch"]:
            raise ValueError("the program's packed domain does not state its scenes")
        out.append(scene.batch_rows(stack))
    return cfg, dom, out
