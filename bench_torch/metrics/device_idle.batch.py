"""device_idle: the share of the traced stretch's wall time in which no
device activity ran (profiler: one minus the union of all device activity
intervals over the stretch), in %."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0
