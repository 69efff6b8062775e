"""Seconds of host time inside the recording blocks of every CUDA graph
capture of the run (`torch.cuda.graph(...)`, instantiation included; not
the warm-up before it, nor the first replay): the `record_ns` count of the
program's `graph` counter family at the end of a traced run."""

from portbench import harness


def read(run):
    counts = harness.load_module("metrics", "graphs_captured").graph_counts(
        run)
    return None if counts is None else counts["record_ns"] / 1e9
