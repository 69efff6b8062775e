"""Port vs TPU package: `EmptyMetric` and `SATAccuracySolver`, the
solver-backed cross-check of `SATAccuracy`, on the same batches and
predictions (`tests/test_metrics.py` holds the TPU package's two
implementations against each other)."""

import numpy as np
import pytest
import torch

from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_tpu.graph.batch import build_batch as jbuild_batch
from diffusionsat_tpu.train import metrics as jmetrics
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.train import metrics as tmetrics

BUCKET = dict(max_vars=32, max_clauses=64, max_edges=256, max_graphs=4)
FORMULAS = [(3, [[1, 2], [-1, 3], [-2, -3]]), (2, [[1, -2], [-1, 2]])]
SOLS = [[1, 0, 1], [1, 1]]


def _batches():
    return (jbuild_batch(FORMULAS, JBucketSpec(**BUCKET), solutions=SOLS),
            build_batch(FORMULAS, BucketSpec(**BUCKET), solutions=SOLS))


@pytest.mark.parametrize("bits", [[1, 0, 1, 1, 0], [1, 0, 1, 1, 1],
                                  [0, 1, 0, 0, 1]])
def test_solver_metric_reads_what_the_tpu_packages_reads(bits):
    jb, tb = _batches()
    logits = np.full(jb.V, -5.0, dtype=np.float32)
    logits[:5] = np.where(np.asarray(bits) > 0, 5.0, -5.0)
    readings = []
    for m, b, pred in ((jmetrics.SATAccuracySolver(), jb, logits),
                       (tmetrics.SATAccuracySolver(), tb,
                        torch.from_numpy(logits)),
                       (tmetrics.SATAccuracy(), tb,
                        torch.from_numpy(logits))):
        m.update_state({"prediction": pred}, b)
        m.update_state({"prediction": pred}, b)      # accumulates
        readings.append(m.get_values())
        assert m.get_values() == {"accuracy": 0.0,       # reset
                                  "total_accuracy": 0.0}
    jv, tv, arr = readings
    assert tv == jv
    assert tv["total_accuracy"] == arr["total_accuracy"]


def test_empty_metric_reads_nothing():
    jb, tb = _batches()
    for m, b in ((jmetrics.EmptyMetric(), jb), (tmetrics.EmptyMetric(), tb)):
        m.update_state({"prediction": np.zeros(jb.V)}, b)
        assert m.get_values() == {}
