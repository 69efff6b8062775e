"""Share of the traced stretch in which the card idled while the host ran
the model's own Python around the graph: inside `eval.batch` or
`predict.step` (`evaluate_metrics`, the predict step, the model's prologue
and epilogue, the metric update) but in no `graph.*` span, in percent
(`idle_feed.train.py`'s reading)."""

from portbench import harness


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    return idle.share(run, idle.MODEL_HOST)
