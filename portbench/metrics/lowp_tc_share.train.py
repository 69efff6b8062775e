"""Share of a train replay's f32-accumulating products (`ops/lowp.py`)
that ran on the card's tensor cores, in percent: the products that the
traced stretch's `graph.replay` spans credit to the `tensor_core` and
`split` routes (the capture's counts of the program's `lowp` counter
family, once a replay), over all of them with the `plain` route's (the
upcast f32 products of the CPU). A program whose replay spans carry no
such counts, or a stretch with no replay of a product, reads nothing."""

from portbench import harness

ROUTES = ("tensor_core", "split", "plain")


def share(spans):
    counts = dict.fromkeys(ROUTES, 0)
    for s in spans:
        if s.name == "graph.replay":
            for route in ROUTES:
                counts[route] += s.attrs.get(f"lowp_{route}", 0)
    total = sum(counts.values())
    if not total:
        return None
    return 100.0 * (counts["tensor_core"] + counts["split"]) / total


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    spans = idle.program_spans(run.rec.trace)
    return None if spans is None else share(spans)
