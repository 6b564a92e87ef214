"""render_ms.interactive: the median host time of ``Session.render`` a frame
(host clock; frames outside the traced stretch)."""

import statistics


def read(run):
    if not run.render_s:
        return None
    return statistics.median(run.render_s) * 1e3
