"""The port's host utilities against the TPU package's: the wall-clock
`Timer` and the CNF pictures' spring layout, held bit for bit."""

import itertools
import sys
import time

import numpy as np
import pytest

from diffusionsat_tpu.utils import measure as jmeasure
from diffusionsat_tpu.utils import sat_visualizer as jvis
from diffusionsat_torch.models import neurocore as tnc
from diffusionsat_torch.utils import measure as tmeasure
from diffusionsat_torch.utils import sat_visualizer as tvis

CLAUSES = [[1, -2, 3], [-1, 4], [2, 3, -5], [5, -6, 1], [6, 2]]


def _timer_story(timer_cls, monkeypatch):
    """What a Timer reads through a fixed sequence of clock readings."""
    ticks = itertools.count(start=10.0, step=0.5)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    story = []
    t = timer_cls()
    with pytest.raises(AssertionError, match="not started"):
        t.lap()
    t.start()
    story += [t.lap(), t.lap(), t.stop()]
    with pytest.raises(AssertionError, match="not started"):
        t.stop()
    t = timer_cls(start_now=True)
    story += [t.lap(), t.stop()]
    with pytest.raises(AssertionError):
        t.lap()
    return story


def test_timer_behaves_as_the_tpu_packages(monkeypatch):
    want = _timer_story(jmeasure.Timer, monkeypatch)
    assert want == [0.5, 1.0, 1.5, 0.5, 1.0]
    assert _timer_story(tmeasure.Timer, monkeypatch) == want


def test_timer_reads_the_wall_clock():
    t = tmeasure.Timer(start_now=True)
    first = t.lap()
    assert 0.0 <= first <= t.lap() <= t.stop()


def _interaction_edges(clauses):
    pairs = {tuple(sorted((abs(u) - 1, abs(v) - 1)))
             for c in clauses for u, v in itertools.combinations(c, 2)}
    return np.asarray(sorted(p for p in pairs if p[0] != p[1]),
                      dtype=int).reshape(-1, 2)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("graph", ["interaction", "edgeless", "one_node",
                                   "factor"])
def test_spring_layout_equals_the_tpu_packages(graph, seed):
    if graph == "interaction":
        n, edges = 6, _interaction_edges(CLAUSES)
    elif graph == "edgeless":
        n, edges = 5, np.zeros((0, 2), dtype=int)
    elif graph == "one_node":
        n, edges = 1, np.zeros((0, 2), dtype=int)
    else:
        n = 6 + len(CLAUSES)
        edges = np.asarray([(abs(lit) - 1, 6 + ci)
                            for ci, c in enumerate(CLAUSES) for lit in c])
    want = jvis._spring_layout(n, edges, iters=40, seed=seed)
    got = tvis._spring_layout(n, edges, iters=40, seed=seed)
    assert got.shape == (n, 2) and np.isfinite(got).all()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("draw", ["draw_interaction_graph",
                                  "draw_factor_graph"])
def test_drawings_are_written(tmp_path, draw):
    pytest.importorskip("matplotlib")
    got = getattr(tvis, draw)(6, CLAUSES, tmp_path / "port.png")
    want = getattr(jvis, draw)(6, CLAUSES, tmp_path / "tpu.png")
    assert got == tmp_path / "port.png"
    assert got.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert got.stat().st_size > 1000
    assert got.read_bytes() == want.read_bytes()


def test_drawing_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tvis.draw_factor_graph(6, CLAUSES, tmp_path / "none.png")
    assert not list(tmp_path.iterdir())


def test_simple_neurosat_config_is_the_tpu_packages():
    from diffusionsat_tpu.models import neurocore as jnc

    for kw in ({}, {"feature_maps": 16, "test_rounds": 3}):
        got, want = tnc.simple_neurosat_config(**kw), \
            jnc.simple_neurosat_config(**kw)
        assert type(got) is tnc.NeuroCoreConfig and got.use_query
        for name in want.__dataclass_fields__:
            assert getattr(got, name) == getattr(want, name), name
