"""frame_ms_p95: the 95th percentile of every frame's latency in the window,
from the mouse input set to the render on the host and the frame
synchronised (host clock; ``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    if len(run.latencies) < 20:
        return None
    return statistics.quantiles(run.latencies, n=100)[94] * 1e3
