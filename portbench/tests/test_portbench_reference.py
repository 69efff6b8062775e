"""The plain references against the program at small widths on the CPU,
through a whole run of each cell (its check is the comparison)."""

import types

import pytest
import torch

from portbench import control, harness
from portbench import run as run_mod

from _small import small


def one_run(workload, overrides, seed=2 ** 31 + 12345, trace=0):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.5,
                                 trace=trace)
    return run_mod.run(args, device="cpu", overrides=overrides)


@pytest.mark.parametrize("workload", ["qs-train-dense-bf16",
                                      "anf-train-flat"])
def test_training_cells_follow_the_reference_in_f32(workload):
    over = small(workload, precision="f32")
    res = one_run(workload, over)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    # every number the check reads, compared or not
    numbers = control.readings(workload, 2 ** 31 + 12345, None, [],
                               device="cpu", overrides=over)[0]
    assert numbers["loss_gap"] < 1e-5
    assert numbers["early_loss_gap"] < 1e-5
    assert numbers["grad1_gap"] < 1e-4
    assert numbers["change3_gap"] < 1e-3


def test_block_bf16_training_is_near_the_f32_reference():
    res = one_run("qs-train-dense-bf16", small("qs-train-dense-bf16"))
    assert res["checks"]["loss_gap"]["value"] < 3e-3


def test_solve_cell_follows_the_reference():
    res = one_run("qs-solve-flat", small("qs-solve-flat"))
    assert res["correct"] is True
    assert res["checks"]["logit_gap"]["value"] < 1e-5
    assert res["metrics"]["solve_graphs_per_s"]["value"] > 0


def test_the_same_seed_gives_the_same_inputs():
    ref = harness.load_module("reference", "querysat-3sat-128")
    cfg = harness.load_json("configs", "querysat-3sat-128")
    a = dict(ref.flatten(ref.init_params(cfg, 2 ** 33 + 1, "cpu")))
    b = dict(ref.flatten(ref.init_params(cfg, 2 ** 33 + 1, "cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    gen3 = __import__("portbench.gen.threshold_3sat", fromlist=["x"])
    mega = harness.load_module("drivers", "_mega")
    tr = harness.load_json("traffic", "threshold3sat-solve-2016")
    p1 = gen3.sized_pool(mega.seeds(2 ** 32 + 7)[0], tr)
    p2 = gen3.sized_pool(mega.seeds(2 ** 32 + 7)[0], tr)
    p3 = gen3.sized_pool(mega.seeds(2 ** 32 + 8)[0], tr)
    assert p1 == p2 and p1 != p3
    # every seed draws the same sizes
    assert sorted(n for n, *_ in p1) == sorted(n for n, *_ in p3)


def test_threshold_formulas_are_well_formed():
    gen3 = __import__("portbench.gen.threshold_3sat", fromlist=["x"])
    import numpy as np
    rng = np.random.default_rng(5)
    for n in (3, 4, 17, 30):
        cl = gen3.formula(rng, n)
        assert len(cl) == gen3.clause_count(n)
        for c in cl:
            assert len({abs(x) for x in c}) == 3
            assert all(1 <= abs(x) <= n for x in c)


def test_reference_graph_and_anf_graph():
    ref = harness.load_module("reference", "anfsat-sha1-r17")
    # x1 + x1*x2 + 1 = 0 and x2 + x1*x2 = 0: one shared AND node
    g = ref.build_graph([(2, [[(1,), (1, 2), ()], [(2,), (2, 1)]])], "cpu")
    assert (g.V, g.A, g.C) == (2, 1, 2)
    assert g.node.tolist() == [1, 3, 0, 2, 3]
    assert g.and1.tolist() == [0] and g.and2.tolist() == [1]
