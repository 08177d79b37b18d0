"""The encoder's waits on the entropy worker per coded frame: the
main thread's ``entropy_wait`` spans (``Encoder._reap_one`` and
``get_packet`` blocked on a syntax job) over the frames the window's
``keyframe`` and ``inter_frame`` spans coded. Nothing where the program's
spans carry no ``thread`` (a program without the span)."""


def read(run):
    frames = run.spans_named("keyframe", "inter_frame")
    if not frames or "thread" not in frames[0]:
        return None
    return sum(s["dur"] for s in run.spans_named("entropy_wait")) \
        / len(frames)
