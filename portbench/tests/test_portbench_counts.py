"""The useful work and the bytes the metrics divide by, against hand
counts at small sizes."""

from portbench import harness

CFG = {"feature_maps": 4, "query_maps": 2, "logit_maps": 3,
       "msg_layers": 3, "update_layers": 3, "output_layers": 2,
       "query_layers": 2, "clauses_layers": 2, "update_scale": 1.5,
       "output_scale": 1.0, "clauses_scale": 2.0, "query_scale": 2.0,
       "train_rounds": 5}


def test_querysat_step_flops_by_hand():
    fl = harness.load_module("flops", "querysat-3sat-128")
    # v1 = 4 + 4 + 5 = 13 columns; layer widths by hand
    update = 19 * 6 + 6 * 6 + 6 * 4        # [2 + 13 + 4, 6, 6, 4]
    output = 4 * 4 + 4 * 3                 # [4, 4, 3]
    query = 13 * 4 + 4 * 2                 # [13, 4, 2]
    lit = 13 * 8 + 8 * 8 + 8 * 4           # [13, 8, 8, 4]
    clause = 8 * 8 + 8 * 6                 # [4 + 4, 8, 4 + 2]
    assert fl.row_macs(CFG) == (update + output + query + lit, clause)
    item = {"n_vars": 7, "n_clauses": 11, "n_edges": 33, "rounds": 9}
    mlp = 7 * (update + output + query + lit) + 11 * clause
    inc = 4 * 33 * 2
    assert fl.step_flops(CFG, item, "train") == \
        {"mlp": mlp * 2 * 5 * 3, "incidence": inc * 2 * 5 * 3}
    assert fl.step_flops(CFG, item, "solve") == \
        {"mlp": mlp * 2 * 9, "incidence": inc * 2 * 9}


def test_querysat_widths_of_the_published_config():
    fl = harness.load_module("flops", "querysat-3sat-128")
    cfg = harness.load_json("configs", "querysat-3sat-128")
    var, clause = fl.row_macs(cfg)
    assert var == (521 * 230 + 230 * 230 + 230 * 128) + \
        (128 * 128 + 128 * 8) + (137 * 153 + 153 * 128) + \
        (137 * 512 + 512 * 512 + 512 * 256)
    assert clause == 384 * 204 + 204 * 256


def test_anfsat_step_flops_by_hand():
    fl = harness.load_module("flops", "anfsat-sha1-r17")
    cfg = {"feature_maps": 4, "query_maps": 2, "msg_layers": 2,
           "vote_layers": 2, "update_scale": 2.0, "output_scale": 1.0,
           "clauses_scale": 1.5, "query_scale": 3.0, "train_rounds": 2}
    item = {"n_vars": 5, "n_ands": 3, "n_clauses": 4, "n_edges": 10}
    per_var = (8 * 6 + 6 * 2) + (4 * 6 + 6 * 2) + (6 * 8 + 8 * 4) + \
        (4 * 4 + 4 * 1)     # query, var2clause, update, output
    per_and = (8 * 6 + 6 * 2) + (10 * 6 + 6 * 2)    # var2ands, ands
    per_clause = 8 * 8 + 8 * 6
    mlp = 5 * per_var + 3 * per_and + 4 * per_clause
    sums = 3 * 2 * 10 + 2 * 2 * 3
    assert fl.step_flops(cfg, item, "train") == \
        {"mlp": mlp * 2 * 2 * 3, "incidence": sums * 2 * 2 * 3}


def test_segsum_bytes_by_hand():
    m = harness.load_module("metrics", "segsum_roofline.solve")
    item = {"n_vars": 3, "n_lits": 5, "n_clauses": 2, "n_edges": 6}
    got = m.launch_bytes(item)
    assert got["lit_to_clause"] == 5 * 128 * 4 + 6 * 4 + 2 * 128 * 4 + 3 * 4
    assert got["clause_to_lit"] == 2 * 128 * 4 + 6 * 4 + 6 * 128 * 4 + 7 * 4


def test_mfu_weights_each_class_by_its_peak():
    import types
    rec = harness.Record()
    rec.counters["stretch_items"] = [{"n_vars": 10, "n_clauses": 40,
                                      "n_edges": 120, "n_graphs": 1}]
    rec.trace = types.SimpleNamespace(window_s=2.0)
    cfg = dict(harness.load_json("configs", "querysat-3sat-128"))
    run = types.SimpleNamespace(rec=rec, config=cfg,
                                config_name="querysat-3sat-128",
                                traffic={"precision": "block_bf16"},
                                peaks=harness.peaks())
    fl = harness.load_module("flops", "querysat-3sat-128")
    f = fl.step_flops(cfg, rec.counters["stretch_items"][0], "train")
    want = 100 * (f["mlp"] + f["incidence"]) / 989e12 / 2.0
    got = harness.load_module("metrics", "mfu.train").read(run)
    assert abs(got - want) <= 1e-12 * want
