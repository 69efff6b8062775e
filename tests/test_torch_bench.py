"""The port's bench against the TPU package's `bench.py`: its workload,
its matmul accounting, and a tiny run on the CPU."""

import numpy as np
import pytest

from _torch_parity import assert_batches_equal
from bench import _matmul_macs as jmatmul
from bench import _mlp_row_macs as jrow
from bench import _useful_macs as juseful
from diffusionsat_tpu.data import bench_workloads as jwork
from diffusionsat_tpu.models.query_sat import QuerySATConfig as JConfig
from diffusionsat_torch import bench
from diffusionsat_torch.data import bench_workloads as twork
from diffusionsat_torch.models.query_sat import QuerySATConfig as TConfig


@pytest.mark.parametrize("budget,n_batches", [(600, 3), (2000, 2)])
def test_sorted_workload_equals_the_tpu_packages(budget, n_batches):
    want = jwork.threshold_3sat_batches_sorted(
        np.random.default_rng(0), budget, n_batches, with_formulas=True)
    got = twork.threshold_3sat_batches_sorted(
        np.random.default_rng(0), budget, n_batches, with_formulas=True)
    assert len(got) == len(want) >= n_batches
    for (jb, je, jf, js), (tb, te, tf, ts) in zip(want, got):
        assert je == te and jf == tf and js == ts
        assert_batches_equal(jb, tb)
    # batches are size-sorted: the first holds the smallest formulas
    sizes = [max(n for n, _ in f) for _, _, f, _ in got]
    assert sizes == sorted(sizes)


@pytest.mark.parametrize("kw", [{}, dict(feature_maps=16, query_maps=8,
                                         logit_maps=4)])
def test_accounting_equals_bench_py(kw):
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert bench._mlp_row_macs(tcfg) == jrow(jcfg)
    for G, Vg, Cg in ((16, 24, 112), (8, 16, 72), (32, 6, 48)):
        assert bench._matmul_macs(tcfg, G, Vg, Cg) == \
            jmatmul(jcfg, G, Vg, Cg)
    assert bench._useful_macs(tcfg, 1000, 4000, 12000) == \
        juseful(jcfg, 1000, 4000, 12000)
    # full occupancy: the useful work is the padded work
    G, Vg, Cg = 16, 24, 112
    assert bench._useful_macs(tcfg, G * Vg, G * Cg, G * Cg * 2 * Vg) == \
        bench._matmul_macs(tcfg, G, Vg, Cg)


@pytest.mark.parametrize("mega", ["0", "3"])
def test_bench_runs_tiny_on_the_cpu(mega, monkeypatch, capsys):
    monkeypatch.setenv("DSAT_BENCH_NODES", "600")
    monkeypatch.setenv("DSAT_BENCH_WINDOWS", "2")
    monkeypatch.setenv("DSAT_MEGA_STEPS", mega)
    out = bench.main(["--device", "cpu", "--feature_maps", "16",
                      "--query_maps", "8", "--rounds", "2", "--cycles", "1",
                      "--n_batches", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    assert json.loads(line) == json.loads(json.dumps(out))
    for key in ("metric", "value", "step_time_ms", "window_ms", "mde_pct",
                "variant", "busy_share", "card", "matmul_peak_basis",
                "pct_of_sol"):
        assert key in out, key
    assert out["metric"] == "train_edge_throughput"
    assert out["variant"] == ("dense" if mega == "0" else "dense_mega3")
    assert len(out["window_ms"]) == 2 and out["value"] > 0
    # a CPU run names its device and measures no device share
    assert out["device"] == "cpu" and out["busy_share"] is None
    assert "67 TFLOP/s" in out["matmul_peak_basis"]
