"""Share of the traced stretch in which the card idled while the host
looked up the round's CUDA graph or copied params, batch, plans and carry
into its buffers, in percent (`idle_feed.train.py`'s reading)."""

from portbench import harness


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    return idle.share(run, idle.FEED)
