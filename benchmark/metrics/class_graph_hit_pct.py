"""The share of the key-frame program's class steps that replayed a CUDA
graph: 100 x ``graph_replays`` / (``graph_replays`` + ``graph_captures``)
over the window's ``tile_program`` spans. Nothing where the spans lack
the counts."""


def read(run):
    spans = [s for s in run.spans_named("tile_program")
             if "graph_replays" in s and "graph_captures" in s]
    replays = sum(s["graph_replays"] for s in spans)
    met = replays + sum(s["graph_captures"] for s in spans)
    return 100.0 * replays / met if met else None
