"""The reader of the key-frame program's share of class steps that
replayed a CUDA graph, on synthetic spans: it reads the ``tile_program``
spans' counts, and nothing from a program whose spans lack them."""

from benchmark import harness


def _run(spans):
    run = harness.Run()
    run.spans = spans
    return run


def _program(**counts):
    return {"stage": "tile_program", "start": 0.3, "dur": 3.0,
            "thread": "MainThread", "syncs": 0, "lanes": 40, **counts}


def test_class_graph_hit_pct_reads_the_tile_program_counts():
    spans = [_program(class_steps=60, graph_replays=58, graph_captures=2,
                      pad_lanes=5),
             _program(class_steps=40, graph_replays=40, graph_captures=0,
                      pad_lanes=0)]
    assert harness.read_metric("class_graph_hit_pct", _run(spans)) == 98.0


def test_class_graph_hit_pct_reads_nothing_without_the_counts():
    """The spans of a program without the graphs: class steps alone."""
    for spans in ([_program(class_steps=100)], [], None):
        assert harness.read_metric("class_graph_hit_pct",
                                   _run(spans)) is None
