"""The stream driver's own time per coded frame: the window's wall minus
the main thread's ``keyframe`` and ``inter_frame`` spans, over the frames
those spans coded. It holds the driver's waits for the entropy worker
(``get_packet``, ``_join_syntax``) and the frames' host-side work outside
the two spans."""


def read(run):
    frames = run.spans_named("keyframe", "inter_frame")
    if not frames or run.window_s is None:
        return None
    return (run.window_s - sum(s["dur"] for s in frames)) / len(frames)
