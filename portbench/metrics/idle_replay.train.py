"""Share of the traced stretch in which the card idled inside the
program's `graph.replay` spans: the replay of a train chunk's graph, with
its generator lent and handed back, in percent (`idle_feed.train.py`'s
reading)."""

from portbench import harness


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    return idle.share(run, idle.REPLAY)
