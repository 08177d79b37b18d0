"""Shown frames whose packets came out in the window, over the time from
the window's start to the last of those packets."""


def read(run):
    if run.frames and run.window_s:
        return run.frames / run.window_s
    return None
