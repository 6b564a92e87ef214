"""rebins_per_frame: the Session's re-bin counter (``Session.rebins()``),
read around each call of the traced stretch (a restore resets it), over
the stretch's frames."""


def read(run):
    if run.traced_frames == 0:
        return None
    return run.rebins / run.traced_frames
