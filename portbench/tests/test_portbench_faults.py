"""`correct` comes out false when the timed path is broken underneath a
run, and the controls (the reference one precision below the
configuration's) fail a limit, at small sizes on the CPU. The same
readings at the cells' own sizes come from `python3 -m
portbench.control` on the card (`test_controls_on_the_card`)."""

import contextlib
import types

import pytest

from portbench import control
from portbench import run as run_mod

from _small import small


def run_broken(workload, fault_ctx, overrides=None, seed=2 ** 31 + 99):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.5,
                                 trace=0)
    with fault_ctx:
        return run_mod.run(args, device="cpu",
                           overrides=overrides or small(workload))


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer update returns the params and state it was given:
    a step that returns its state unchanged."""
    from diffusionsat_torch.train.adabelief import AdaBelief
    orig = AdaBelief.update
    AdaBelief.update = lambda self, grads, state, params: (params, state)
    try:
        yield
    finally:
        AdaBelief.update = orig


@pytest.mark.parametrize("workload", ["qs-train-dense-bf16",
                                      "anf-train-flat"])
def test_a_step_that_leaves_its_state_unchanged(workload):
    res = run_broken(workload, state_unchanged())
    assert res["correct"] is False
    assert res["checks"]["change3_gap"]["value"] == pytest.approx(1.0)


@contextlib.contextmanager
def rows_past_two_repeat_row_two():
    """A chunk's steps past its third train on the third step's rows: a
    fault of the per-step slicing of the stacked feed, which only a
    whole chunk through the window's graph meets."""
    from diffusionsat_torch import cuda_graphs
    orig = cuda_graphs.index_tree
    cuda_graphs.index_tree = lambda tree, i: orig(tree, min(i, 2))
    try:
        yield
    finally:
        cuda_graphs.index_tree = orig


@pytest.mark.parametrize("workload", ["qs-train-dense-bf16",
                                      "anf-train-flat"])
def test_a_chunk_that_repeats_a_row(workload):
    res = run_broken(workload, rows_past_two_repeat_row_two())
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > \
        res["checks"]["loss_gap"]["limit"]


def test_half_the_batch_left_out_dense():
    res = run_broken("qs-train-dense-bf16",
                     control.planted("half_batch", "train_dense"),
                     overrides=small("qs-train-dense-bf16"))
    assert res["correct"] is False


def test_half_the_batch_left_out_anf():
    readings = control.readings("anf-train-flat", 2 ** 31 + 5, None,
                                ["half_batch"], device="cpu",
                                overrides=small("anf-train-flat"))
    limits = control.harness.load_json("traffic", "sha1-r17-anf-mega8")[
        "limits"]["anfsat-sha1-r17"]
    fault = next(r for r in readings if r["reading"] == "half_batch")
    assert any(fault[k] > limits[k] for k in limits)


def test_an_answer_altered_where_it_is_produced():
    res = run_broken("qs-solve-flat",
                     control.planted("answer_altered", "solve_flat"))
    assert res["correct"] is False


@pytest.mark.parametrize("workload,precision,traffic", [
    ("qs-train-dense-bf16", "fp8", "threshold3sat-20k-sorted-mega8"),
    ("anf-train-flat", "tf32", "sha1-r17-anf-mega8"),
    ("qs-solve-flat", "tf32", "threshold3sat-solve-2016")])
def test_the_control_fails_a_limit(workload, precision, traffic):
    readings = control.readings(workload, 2 ** 31 + 7, precision, [],
                                device="cpu", overrides=small(workload),
                                seconds=0.5)
    limits = next(iter(control.harness.load_json("traffic", traffic)[
        "limits"].values()))
    ctl = next(r for r in readings if r["reading"].startswith("control"))
    assert any(ctl[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,precision", [
    ("qs-train-dense-bf16", "fp8"), ("anf-train-flat", "tf32"),
    ("qs-solve-flat", "tf32")])
def test_controls_on_the_card(card, workload, precision):
    """At the cells' own sizes: the program within every limit, the
    control beyond one."""
    traffic = run_mod.cell_spec(workload)["traffic"]
    limits = next(iter(control.harness.load_json("traffic", traffic)[
        "limits"].values()))
    readings = control.readings(workload, 2 ** 31 + 21, precision, [])
    prog = next(r for r in readings if r["reading"] == "program")
    ctl = next(r for r in readings if r["reading"].startswith("control"))
    assert all(prog[k] <= limits[k] for k in limits)
    assert any(ctl[k] > limits[k] for k in limits)
