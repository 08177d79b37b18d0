"""The key-frame program's time per class step: the window's
``tile_program`` spans (issuing the wave x class loop of
``ops/device_tile.py``) over the class steps they ran (their
``class_steps``), in milliseconds."""


def read(run):
    spans = [s for s in run.spans_named("tile_program")
             if "class_steps" in s]
    steps = sum(s["class_steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s["dur"] for s in spans) / steps
