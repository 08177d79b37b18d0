"""Span ``dlf`` (the deblocking filter's search and apply) per frame."""


def read(run):
    spans = run.spans_named("dlf")
    return sum(s["dur"] for s in spans) / len(spans) if spans else None
