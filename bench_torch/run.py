"""Run one cell of the benchmark of the PyTorch and CUDA port (``fluid_tpu_torch``).

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 bench_torch/run.py --workload dam3d-1m.settle --seed 7 --seconds 10 --trace 0

Prints the card and its power limit, then, as the last lines of standard
error, each number the output check compared beside its limit, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``.  Exits 2 and prints no result without
as many CUDA cards as the cell asks for.

The program's build and kernel caches are kept in ``.bench_cache/`` of the
checkout (the program's own nvcc build stays in ``fluid_tpu_torch/_build/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one host thread for the program's CPU-side work: a steadier load
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; have {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", file=sys.stderr)

    from bench_torch import harness

    result, lines, _ = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                                        torch.device("cuda", 0), T_START)
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
