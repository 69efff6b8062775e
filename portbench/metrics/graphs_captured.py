"""CUDA graphs the program recorded in the whole run: the `captures`
count of its `graph` counter family (`diffusionsat_torch/tracing.py`) at
the end of a traced run. A program without counters, or a run with no
traced stretch, reads nothing."""


def graph_counts(run):
    if run.rec.trace is None:
        return None
    try:
        from diffusionsat_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get("graph")


def read(run):
    counts = graph_counts(run)
    return None if counts is None else counts["captures"]
