"""Readings that set a cell's limits: the program's check numbers and the
control's, seed by seed, in one process.

For each seed: the cell's set-up, a short window at the cell's own load
(``--seconds``), then the run's check frames (``harness.Run.check``) with
the control: the reference with TF32 contractions (``reference.tf32``)
put in the program's place, compared with the same float32 reference by
the same numbers.  With ``--witness``, each check frame is also run by
the program's plain dense backend (``step.frame``) from the same start
and compared with the reference by the same numbers (``witness``).  One
JSON line a seed, on the card::

    python3 bench_torch/control.py --workload dam3d-1m.settle --seeds 1,2,3 --seconds 2

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def dense_witness(run, frames: list) -> dict:
    """Each check frame by the program's dense backend from the same start,
    against the float32 reference."""
    from bench_torch import compare, reference
    from fluid_tpu_torch import step
    from fluid_tpu_torch.state import ParticleState

    out, phys = {}, run.conf["physics"]
    for fr in frames:
        s = fr["start"]
        p = ParticleState(**{k: s[k].clone() for k in ("pos", "vel", "C", "mass", "density",
                                                       "pressure")})
        mouse = step.mouse(fr["mouse"]) if fr["mouse"] is not None else step.no_mouse()
        mouse = tuple(t.to(s["pos"].device) for t in mouse)
        q = step.frame(p, run.cfg, run.dom, *mouse, backend="dense")
        got = {k: getattr(q, k) for k in ("pos", "vel", "C", "density", "pressure")}
        start = {k: s[k] for k in ("pos", "vel", "C", "mass")}
        want = reference.frame(start, phys, mouse=fr["mouse"])
        out.update({fr["prefix"] + k: v for k, v in compare.numbers(got, want, phys).items()})
    return out


def readings(bench: dict, cell: dict, seed: int, seconds: float, device,
             witness: bool = False) -> dict:
    """One seed's program and control numbers of ``cell``."""
    from bench_torch import harness

    conf, traffic, limits = harness.cell_files(bench, cell)
    run = harness.Run(conf, traffic, seed, device)
    run.setup()
    run.window(seconds, False, time.perf_counter())
    kept = []
    if witness:
        check = run.driver.check

        def keep(r):
            frames = check(r)
            kept.extend(frames)
            return frames

        run.driver.check = keep
    run.check(limits, control=True)
    out = {"seed": seed, "frames": run.frames, "error": run.error,
           "program": getattr(run, "numbers", None), "control": getattr(run, "control", None)}
    if witness and run.error is None:
        out["witness"] = dense_witness(run, run.setup_checks + kept)
    return out


def main(argv=None) -> int:
    import torch

    from bench_torch import harness, run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    print(f"[card] {run.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **readings(bench, cell, seed, args.seconds, torch.device("cuda", 0),
                                     args.witness)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
