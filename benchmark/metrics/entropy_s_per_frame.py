"""Span ``entropy`` (a frame's syntax and range coding, on the entropy
worker thread) per frame."""


def read(run):
    spans = run.spans_named("entropy")
    return sum(s["dur"] for s in spans) / len(spans) if spans else None
