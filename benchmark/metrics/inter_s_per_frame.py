"""Span ``inter_frame`` (an inter frame's compute) per inter frame."""


def read(run):
    spans = run.spans_named("inter_frame")
    return sum(s["dur"] for s in spans) / len(spans) if spans else None
