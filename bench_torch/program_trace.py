"""The program's own recorder (``fluid_tpu_torch.utils.timing``) as the metric
readers see it: None where the program has none (an older program), so a
reader of it returns None there."""


def recorder():
    """The program's recorder, or None."""
    try:
        from fluid_tpu_torch.utils.timing import recorder as program_recorder
    except ImportError:
        return None
    return program_recorder()


def tail(run):
    """(recorder, (t0, t1)): a traced run's untraced tail in perf_counter_ns,
    from the end of the first ``Session.particles`` span after the traced
    stretch (the occupied-cells count) to the start of the next (the
    check); None without a recorder, a stretch or such spans."""
    rec = recorder()
    if rec is None or not hasattr(run, "stretch"):
        return None
    found = rec.gap_after("particles", int(run.stretch._t1 * 1e9))
    return (rec, found) if found else None
