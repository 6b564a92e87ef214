"""session_idle_ms.interactive: the device's idle time (no frame graph on it)
while the host is inside ``Session.frame`` (its ``mouse``, ``replay`` launch
and strict ``check``) or ``Session.block_until_ready`` (``sync``), ms a
frame, over the untraced tail (the program's recorder, ``idle_by_span``;
the tail as ``program_trace.tail`` finds it).  None where the program keeps
no stamps."""

from bench_torch import program_trace


def read(run):
    found = program_trace.tail(run)
    idle = found[0].idle_by_span(*found[1]) if found else None
    if idle is None:
        return None
    from fluid_tpu_torch.utils.timing import idle_under

    frames = sum(1 for n, d, _, _ in found[0].records(*found[1]).spans if n == "frame" and d == 0)
    return idle_under(idle, "frame", "sync") / frames * 1e3 if frames else None
