"""Segsum kernel launches a round in the solving pass: the launches the
traced stretch's `graph.replay` spans credited (what each graph's capture
counted, once a replay), over their replays. `segsum_roofline.solve`
assumes 4."""

from portbench import harness


def per_round(spans):
    replays = launches = 0
    for s in spans:
        if s.name == "graph.replay":
            replays += s.attrs.get("replays", 0)
            launches += s.attrs.get("segsum_launches", 0)
    return launches / replays if replays else None


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    spans = idle.program_spans(run.rec.trace)
    return None if spans is None else per_round(spans)
