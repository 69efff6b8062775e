"""The whole solving pass's share of the card's peak, in percent: the
least time of the traced stretch's batches (64 forward rounds each) at
the peak of the precision the configuration states, over the stretch's
wall time (`mfu.train.py`'s reading)."""

from portbench import harness


def read(run):
    return harness.load_module("metrics", "mfu.train").read(run, "solve")
