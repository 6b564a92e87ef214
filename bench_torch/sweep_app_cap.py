"""The slot cap that holds a configuration's scene under the app's mouse.

For each cap and seed, a strict ``Session`` at the program's own layout for
the scene with that cap (``StreamSpec`` of ``default_spec``'s tile, halo and
active budget) runs the app's frames without the render: the mouse check
frame first (the mouse at the fluid's xy centroid, as ``drivers/app.py``
takes it), then ``--frames`` frames under the traffic mix's drags
(``drivers/app.drag_schedule``), one strict check each.  One JSON line a
run, on the card: the frames done, the first frame at which the strict
check failed (particles lost past a tile's slots) and its message, the
``fill_peak`` watermark (the most particles a binning asked one tile to
hold, before the clip; above the cap on a loss), the re-bins and the host
ms a frame::

    python3 bench_torch/sweep_app_cap.py --config dam2d-ref --caps 128,160 --seeds 1,2 --frames 2000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def sweep_one(conf: dict, traffic: dict, cap: int, seed: int, frames: int, device) -> dict:
    """One strict run at ``cap`` (module docstring)."""
    from bench_torch import harness
    from fluid_tpu_torch import step
    from fluid_tpu_torch.ops import stream_transfer as stx
    from fluid_tpu_torch.session import Session

    drivers = harness.load_module("drivers", traffic["driver"])
    cfg, dom, (p,) = harness.build_scenes(conf, seed, 1, device)
    spec = dataclasses.replace(stx.default_spec(cfg, dom, p.n), cap=cap)
    sess = Session(cfg, dom, p, backend=conf["backend"], spec=spec, device=device)
    sess.compile_run()
    xy = [float(v) for v in p.pos[:, :2].mean(dim=0)]
    mice = [xy] + drivers.drag_schedule(seed, traffic["drag"], conf["app"]["viewport"], frames)
    done, fail = 0, None
    t0 = time.perf_counter()
    for m in mice:
        try:
            sess.frame(step.mouse(m) if m is not None else step.no_mouse())
        except RuntimeError as e:
            fail = str(e)
            break
        done += 1
    secs = time.perf_counter() - t0
    out = {"cap": cap, "seed": seed, "tile": spec.tile, "active": spec.A, "frames": done,
           "failed_at": None if fail is None else done, "error": fail,
           "fill_peak": sess.fill_peak(), "need_peak": sess.need_peak(), "rebins": sess.rebins(),
           "ms_per_frame": secs / max(done, 1) * 1e3}
    del sess
    return out


def main(argv=None) -> int:
    import torch

    from bench_torch import harness, run

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="interactive")
    ap.add_argument("--caps", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    conf = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{args.traffic}.json")
    print(f"[card] {run.card_line()}", flush=True)
    for cap in (int(c) for c in args.caps.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(sweep_one(conf, traffic, cap, seed, args.frames, device)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
