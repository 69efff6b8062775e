"""Port vs TPU package: the model, dataset and solver registries and the
configuration's selection flags."""

import pytest

from diffusionsat_tpu import config as jconfig
from diffusionsat_tpu import registry as jreg
from diffusionsat_torch import config as tconfig
from diffusionsat_torch import registry as treg

PAIRS = [(jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY),
         (jreg.DATASET_REGISTRY, treg.DATASET_REGISTRY),
         (jreg.SOLVER_REGISTRY, treg.SOLVER_REGISTRY)]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0].kind)
def test_same_names_and_aliases(pair):
    j, t = pair
    assert t.kind == j.kind
    assert t.registered_names == j.registered_names


def _port_counterpart(obj):
    return obj.__module__.replace("diffusionsat_tpu", "diffusionsat_torch")


@pytest.mark.parametrize("name", jreg.DATASET_REGISTRY.registered_names)
def test_every_task_resolves_to_the_ports_class(name):
    j, t = jreg.DATASET_REGISTRY.resolve(name), \
        treg.DATASET_REGISTRY.resolve(name)
    assert t.__name__ == j.__name__
    assert t.__module__ == _port_counterpart(j)


@pytest.mark.parametrize("name", jreg.SOLVER_REGISTRY.registered_names)
def test_every_solver_resolves_to_the_ports_class(name):
    j, t = jreg.SOLVER_REGISTRY.resolve(name), \
        treg.SOLVER_REGISTRY.resolve(name)
    assert (t.__name__, t.__module__) == (j.__name__, _port_counterpart(j))


@pytest.mark.parametrize("name", jreg.MODEL_REGISTRY.registered_names)
def test_models_resolve_or_name_their_roadmap_item(name):
    """Every model is ported: config, init and apply of the same names,
    from the port's
    counterpart of the TPU package's module; the alias `simple_neuro_sat`
    resolves to NeuroCore in both, SimpleNeuroSAT's own name to its own
    config (the same init and apply)."""
    cfg, init, apply = treg.MODEL_REGISTRY.resolve(name)
    jcfg, jinit, japply = jreg.MODEL_REGISTRY.resolve(name)
    assert (cfg.__name__, init.__name__, apply.__name__) == \
        (jcfg.__name__, jinit.__name__, japply.__name__)
    for t, j in ((cfg, jcfg), (init, jinit), (apply, japply)):
        assert t.__module__ == _port_counterpart(j)
    if name == "simple_neuro_sat":
        assert cfg.__name__ == "NeuroCoreConfig" and not cfg().use_query
    if name == "simple_neurosat":
        assert cfg.__name__ == "SimpleNeuroSATConfig" and cfg().use_query


def test_unregistered_names_raise_as_there():
    for j, t in PAIRS:
        with pytest.raises(ModuleNotFoundError, match="not registered"):
            j.resolve("no_such_entry")
        with pytest.raises(ModuleNotFoundError, match="not registered"):
            t.resolve("no_such_entry")


def test_config_choices_are_the_registries_names():
    assert list(tconfig.MODELS) == treg.MODEL_REGISTRY.registered_names
    assert list(tconfig.TASKS) == treg.DATASET_REGISTRY.registered_names
    assert list(tconfig.SOLVERS) == treg.SOLVER_REGISTRY.registered_names


@pytest.mark.parametrize("flag,names", [
    ("--model", jreg.MODEL_REGISTRY.registered_names),
    ("--task", jreg.DATASET_REGISTRY.registered_names),
    ("--sat_solver_for_generators", jreg.SOLVER_REGISTRY.registered_names),
])
def test_selection_flags_take_every_name_the_tpu_package_takes(flag, names,
                                                               capsys):
    attr = flag[2:]
    for name in names:
        assert getattr(tconfig.parse_config([flag, name]), attr) == \
            getattr(jconfig.parse_config([flag, name]), attr) == name
    for parse in (tconfig.parse_config, jconfig.parse_config):
        with pytest.raises(SystemExit):
            parse([flag, "no_such_entry"])
    assert "invalid choice" in capsys.readouterr().err
