"""The active budget and the slot cap that hold a packed batch: strict runs.

For each seed, the configuration's scenes as a cell of the ``impact-scenes``
mix draws them (``traffic["scenes"]`` batches from the seed, each kept as a
snapshot), a strict ``Session`` at the program's default spec restores each
batch in turn and runs ``--frames`` frames in calls of one frame, and
records after each call the largest ``need_peak`` (the needed-relay closure
a binning asked for, against the budget A) and ``fill_peak`` (the most
particles a binning asked one tile to hold, against the cap), the re-bins,
the host ms a frame, and the first call at which the strict check failed,
if any.  One JSON line a seed, on the card::

    python3 bench_torch/sweep_batch.py --config batch64 --seeds 1,2 --frames 16
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    conf = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    print(f"[card] {run.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        cfg, dom, batches = harness.build_scenes(conf, seed, args.batches, device)
        sess = harness.make_session(conf, cfg, dom, batches[0], device)
        snaps = [sess.snapshot()] + [harness.make_session(conf, cfg, dom, p, device).snapshot()
                                     for p in batches[1:]]
        del batches
        sess.compile_run()
        need = fill = rebins = 0
        fail, frames, secs = None, 0, 0.0
        for b, snap in enumerate(snaps):
            sess.restore(snap)
            before = sess.rebins()
            t0 = time.perf_counter()
            try:
                for f in range(args.frames):
                    sess.run(1)
                    need, fill = max(need, sess.need_peak()), max(fill, sess.fill_peak())
                    frames += 1
            except RuntimeError as e:
                fail = f"batch {b}, frame {f}: {e}"
                break
            secs += time.perf_counter() - t0
            rebins += sess.rebins() - before
        print(json.dumps({"seed": seed, "frames": frames, "failed": fail,
                          "need_peak": need, "A": sess.spec.A, "fill_peak": fill,
                          "cap": sess.spec.cap, "rebins": rebins,
                          "ms_per_frame": secs / max(frames, 1) * 1e3,
                          "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}),
              flush=True)
        del sess, snaps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
