"""Span ``keyframe`` (the key-frame pass's compute) per key frame."""


def read(run):
    spans = run.spans_named("keyframe")
    return sum(s["dur"] for s in spans) / len(spans) if spans else None
