"""The whole train step's share of the card's peak, in percent.

The least time of the traced stretch's steps, each product class's
useful FLOPs (`flops/<config>.py`) over the peak of the precision the
configuration states for it (`peaks.json`), over the stretch's wall time.
"""

from portbench import harness


def read(run, kind="train"):
    items = run.rec.counters.get("stretch_items")
    t = run.rec.trace
    if not items or t is None or t.window_s <= 0:
        return None
    flops = harness.load_module("flops", run.config_name)
    precision = run.config["precision"][run.traffic["precision"]]
    peak = run.peaks["flops"]
    least = sum(v / peak[precision[k]] for it in items
                for k, v in flops.step_flops(run.config, it, kind).items())
    return 100.0 * least / t.window_s
