"""Seconds of set-up spent capturing CUDA graphs: for every shape the
window uses, its first call less one steady call of it, as the driver
times them (`cuda_graphs.py`)."""


def read(run):
    return run.rec.counters.get("graph_capture_s")
