"""frame_device_ms.interactive: the median device time of a replayed frame
graph, ``frame_end`` minus ``frame_begin`` (the program's recorder), over
the untraced tail (as ``program_trace.tail`` finds it).  None where the
program keeps no stamps."""

import statistics

from bench_torch import program_trace


def read(run):
    found = program_trace.tail(run)
    if not found:
        return None
    t0, t1 = found[1]
    spans = [b - a for n, a, b in found[0].records(t0, t1).device
             if n == "frame" and a >= t0 and b <= t1]
    return statistics.median(spans) * 1e-6 if spans else None
