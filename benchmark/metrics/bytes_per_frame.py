"""Packet bytes out in the window (hidden frames' packets included) over
the shown frames out in it."""


def read(run):
    return run.bytes / run.frames if run.frames else None
