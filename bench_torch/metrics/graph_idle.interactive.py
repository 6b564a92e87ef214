"""graph_idle.interactive: the share of the untraced tail's wall time with no
frame graph on the device, in % (the program's recorder: its
``frame_begin`` / ``frame_end`` device stamps on the host clock,
``idle_by_span``; the tail as ``program_trace.tail`` finds it).  None where
the program keeps no stamps."""

from bench_torch import program_trace


def read(run):
    found = program_trace.tail(run)
    idle = found[0].idle_by_span(*found[1]) if found else None
    if idle is None:
        return None
    t0, t1 = found[1]
    return sum(idle.values()) / ((t1 - t0) * 1e-9) * 100.0
