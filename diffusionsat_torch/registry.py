"""Model, dataset and solver registries.

Counterpart of the TPU package's `registry.py`: the same three registries
with the same names and aliases, each resolving lazily to the port's
class; a name that is not registered raises `ModuleNotFoundError`, as
there. As there, the alias `simple_neuro_sat` resolves to NeuroCore (its
config, init and apply), not to SimpleNeuroSAT.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Callable[[], Any]] = {}

    def register(self, name: str, factory: Callable[[], Any]) -> None:
        self._items[name] = factory

    def resolve(self, name: str):
        if name not in self._items:
            raise ModuleNotFoundError(
                f"{self.kind} '{name}' is not registered! Available:"
                f" {sorted(self._items)}")
        return self._items[name]()

    @property
    def registered_names(self) -> list[str]:
        return sorted(self._items)


def _model_entry(module: str, cfg_name: str, init_name: str, apply_name: str):
    def factory():
        mod = importlib.import_module(module)
        return (getattr(mod, cfg_name), getattr(mod, init_name),
                getattr(mod, apply_name))
    return factory


def _entry(module: str, name: str):
    def factory():
        return getattr(importlib.import_module(module), name)
    return factory


_MODELS = "diffusionsat_torch.models"

MODEL_REGISTRY = Registry("model")
for _name, _module, _cfg, _init, _apply in (
        ("query_sat", "query_sat", "QuerySATConfig", "query_sat_init",
         "query_sat_apply"),
        ("query_sat_lit", "query_sat_lit", "QuerySATLitConfig",
         "query_sat_lit_init", "query_sat_lit_apply"),
        ("neuro_sat", "neuro_sat", "NeuroSATConfig", "neuro_sat_init",
         "neuro_sat_apply"),
        ("neurocore", "neurocore", "NeuroCoreConfig", "neurocore_init",
         "neurocore_apply"),
        ("simple_neurosat", "neurocore", "SimpleNeuroSATConfig",
         "simple_neurosat_init", "simple_neurosat_apply"),
        ("attention_sat", "attention_sat", "AttentionSATConfig",
         "attention_sat_init", "attention_sat_apply"),
        ("anf_sat", "anf_sat", "ANFSATConfig", "anf_sat_init",
         "anf_sat_apply"),
        # the reference's spelling, an alias of NeuroCore there as well
        ("simple_neuro_sat", "neurocore", "NeuroCoreConfig",
         "neurocore_init", "neurocore_apply")):
    MODEL_REGISTRY.register(_name, _model_entry(
        f"{_MODELS}.{_module}", _cfg, _init, _apply))

_GEN = "diffusionsat_torch.data.generators"
_GRAPH = "diffusionsat_torch.data.graph_tasks"
_LOAD = "diffusionsat_torch.data.loaders"
_SHA = "diffusionsat_torch.data.sha"
_SHA_ANF = "diffusionsat_torch.data.sha_anf"

DATASET_REGISTRY = Registry("dataset")
for _name, _module, _cls in (
        ("ksat", _GEN, "KSatInstances"),
        ("3-sat", _GEN, "SAT3Instances"),
        ("diffusion-sat", _GEN, "DiffusionSatInstances"),
        ("clique", _GRAPH, "CliqueInstances"),
        ("domset", _GRAPH, "DomSetInstances"),
        ("kcolor", _GRAPH, "KColorInstances"),
        ("splot", _LOAD, "SplotInstances"),
        ("satlib", _LOAD, "SatLibInstances"),
        ("primes", _LOAD, "PrimesInstances"),
        ("mixed", _LOAD, "MixedInstances"),
        ("sha1", _SHA, "Sha1Instances"),
        ("anf", "diffusionsat_torch.data.anf", "RandomAnfInstances"),
        ("sha1-anf", _SHA_ANF, "Sha1AnfInstances"),
        # the reference's registry spellings, as aliases
        ("k-sat", _GEN, "KSatInstances"),
        ("k_color", _GRAPH, "KColorInstances"),
        ("dominating_set", _GRAPH, "DomSetInstances"),
        ("mix_sat", _LOAD, "MixedInstances"),
        ("sha-gen", _SHA, "Sha1Instances"),
        ("sha-gen2019", _SHA, "Sha1Instances"),
        ("sha-anf", _SHA_ANF, "Sha1AnfInstances")):
    DATASET_REGISTRY.register(_name, _entry(_module, _cls))

_SOLVERS = "diffusionsat_torch.sat.solvers"

SOLVER_REGISTRY = Registry("sat_solver")
for _name, _cls in (
        ("cdcl", "NativeCDCL"),
        ("glucose", "NativeCDCL"),
        ("walksat", "NativeWalkSAT"),
        ("unigen", "UniformSampler"),
        # the reference's solver names -> the nearest in-process solver
        ("default", "NativeCDCL"),
        ("lingeling", "NativeCDCL"),
        ("treengeling", "NativeCDCL"),
        ("quicksampler", "NativeWalkSAT")):
    SOLVER_REGISTRY.register(_name, _entry(_SOLVERS, _cls))
