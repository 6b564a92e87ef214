"""The slot cap that holds a configuration's dam: strict runs at each cap.

For each cap and seed, a strict ``Session`` at the configuration's layout
with that cap runs ``--frames`` frames, in calls of one frame for the
first 40 (the fall and the impact) and of 10 after, and records the
largest tile count seen after each call (``stream_state().count``), the
re-bins, the host ms a frame, and the first call at which the strict
check failed (particles lost past a tile's slots), if any.  One JSON line a
run, on the card::

    python3 bench_torch/sweep_cap.py --config dam3d-1m --caps 128,256 --seeds 1,2 --frames 800
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import torch

    from bench_torch import harness, run

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--caps", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    conf = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    print(f"[card] {run.card_line()}", flush=True)
    for cap in (int(c) for c in args.caps.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            run_conf = json.loads(json.dumps(conf))
            run_conf["layout"]["cap"] = cap
            cfg, dom, (p,) = harness.build_scenes(run_conf, seed, 1, device)
            sess = harness.make_session(run_conf, cfg, dom, p, device)
            sess.compile_run()
            peak, fail, done = 0, None, 0
            t0 = time.perf_counter()
            while done < args.frames:
                step = 1 if done < 40 else 10  # each frame through the fall and the impact
                try:
                    sess.run(step)
                except RuntimeError as e:
                    fail = f"frames {done}-{done + step}: {e}"
                    break
                done += step
                peak = max(peak, int(sess.stream_state().count.max()))
            secs = time.perf_counter() - t0
            print(json.dumps({"cap": cap, "seed": seed, "frames": done, "failed": fail,
                              "max_tile_count": peak, "rebins": sess.rebins(),
                              "ms_per_frame": secs / max(done, 1) * 1e3,
                              "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}),
                  flush=True)
            del sess, p
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
