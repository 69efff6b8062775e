"""LSTM kernel launches a train step, forward and backward: what the
traced stretch's `graph.replay` spans credit to the program's `lstm`
counter family (`lstm_launches`, once a replay), over the steps those
replays ran (`mega_steps` a replay). The program counts them at capture,
as the nodes each cell's forward and backward add to the graph
(`nn/lstm.py`), so a replay runs that many. A program whose replay spans
carry no such count reads nothing."""

from portbench import harness


def per_step(spans, steps_a_replay: int):
    replays = launches = 0
    for s in spans:
        if s.name == "graph.replay" and "lstm_launches" in s.attrs:
            replays += s.attrs.get("replays", 0)
            launches += s.attrs["lstm_launches"]
    return launches / (replays * steps_a_replay) if replays else None


def read(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    spans = idle.program_spans(run.rec.trace)
    if spans is None:
        return None
    return per_step(spans, run.traffic["mega_steps"])
