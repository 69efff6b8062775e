"""The port does everything the TPU package does: every module of that
package has a counterpart at the same path under `diffusionsat_torch/`,
every root script that runs on that package has a `python -m
diffusionsat_torch.<name>` counterpart, and every public top-level name of
a module is there in its counterpart. The exceptions below are the only
ones, each with its reason, and each is checked to still hold."""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TPU = REPO / "diffusionsat_tpu"
PORT = REPO / "diffusionsat_torch"
STACK = {"jax", "diffusionsat_tpu"}

# module -> its counterparts, where the path differs
MOVED_MODULES = {
    # the Pallas kernel becomes a hand-written CUDA kernel and its Python
    # side (plans, wrapper, plain version, autograd)
    "ops/pallas_segsum.py": ("ops/segsum.py", "csrc/segsum.cu"),
}
# root script -> the port's module, where the name differs
RENAMED_SCRIPTS = {"diffusion_sampler.py": "sample.py"}
# root scripts with no counterpart in the port, and why
NOT_PORTED_SCRIPTS = {
    "__graft_entry__.py": "the TPU package's single-chip entry; the port's "
                          "`chip_smoke.py` drives its main paths on the card",
    "chip_smoke.py": "the port's own card check, not a script of the TPU "
                     "package",
}
# (module, name) -> (the port's module, name), where the name moved
RENAMED_NAMES = {
    # one CUDA kernel gathers and sums: its wrapper launches it
    ("ops/pallas_segsum.py", "segsum_pallas"): ("ops/segsum.py",
                                                "gather_segsum"),
    # the stacking of a step's batches lives with the training loop
    ("parallel/dp.py", "stack_batches"): ("train/loop.py", "stack_batches"),
    # clause sharding on the port's process ranks
    ("parallel/graph_partition.py", "shard_gp_batch"): (
        "parallel/graph_partition.py", "shard_batch_by_clause"),
    ("parallel/graph_partition.py", "place_sharded_batch"): (
        "parallel/graph_partition.py", "place_local_batch"),
}
# (module, name) with no counterpart, and why
NO_COUNTERPART = {
    ("tsp/subtours.py", "subtour_pairs_callback"):
        "a host callback out of a compiled step; the port's step runs "
        "eagerly and calls `subtour_pairs` on the host directly",
}


def _modules():
    return sorted(p.relative_to(TPU).as_posix() for p in TPU.rglob("*.py"))


def _module_name(rel: str) -> str:
    parts = pathlib.PurePosixPath(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("diffusionsat_torch",) + parts)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _stack_scripts() -> list[str]:
    """Root scripts that import the TPU stack, directly or through another
    root script."""
    scripts = {p.stem: _imported_roots(p) for p in REPO.glob("*.py")}
    on_stack = {s for s, roots in scripts.items() if roots & STACK}
    while True:
        more = {s for s, roots in scripts.items() if roots & on_stack}
        if more <= on_stack:
            return sorted(f"{s}.py" for s in on_stack)
        on_stack |= more


def _public_names(path: pathlib.Path) -> set[str]:
    """The names a module defines at its top level (not those it imports),
    without the private ones."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for t in (target.elts if isinstance(target, ast.Tuple)
                          else [target]):
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", _modules())
def test_every_module_has_a_counterpart(rel):
    for counterpart in MOVED_MODULES.get(rel, (rel,)):
        assert (PORT / counterpart).is_file(), counterpart


@pytest.mark.parametrize("script", _stack_scripts())
def test_every_script_has_a_counterpart(script):
    if script in NOT_PORTED_SCRIPTS:
        assert not (PORT / script).exists()
        return
    name = RENAMED_SCRIPTS.get(script, script)
    path = PORT / name
    assert path.is_file(), f"{script} has no diffusionsat_torch/{name}"
    assert "__main__" in path.read_text(), f"{name} is not runnable"


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    port_rel = MOVED_MODULES.get(rel, (rel,))[0]
    module = importlib.import_module(_module_name(port_rel))
    missing = []
    for name in sorted(_public_names(TPU / rel)):
        if (rel, name) in NO_COUNTERPART:
            continue
        moved = RENAMED_NAMES.get((rel, name))
        if moved is not None:
            target = importlib.import_module(_module_name(moved[0]))
            if not hasattr(target, moved[1]):
                missing.append(f"{name} -> {moved[0]}:{moved[1]}")
        elif not hasattr(module, name):
            missing.append(name)
    assert not missing, f"{rel}: {missing}"


def test_the_stated_exceptions_still_hold():
    stack = set(_stack_scripts())
    for script in RENAMED_SCRIPTS:
        assert script in stack and not (PORT / script).exists(), script
    for script, why in NOT_PORTED_SCRIPTS.items():
        assert (REPO / script).is_file() and why, script
    for rel in MOVED_MODULES:
        assert (TPU / rel).is_file() and not (PORT / rel).exists(), rel
    for (rel, name), (port_rel, port_name) in RENAMED_NAMES.items():
        assert name in _public_names(TPU / rel), (rel, name)
        assert port_name in _public_names(PORT / port_rel), (rel, name)
    for (rel, name), why in NO_COUNTERPART.items():
        assert name in _public_names(TPU / rel) and why, (rel, name)
        module = importlib.import_module(_module_name(rel))
        assert not hasattr(module, name), (rel, name)


def test_every_jax_script_is_found():
    """The search finds the scripts that run on the stack (among them
    `build_3sat_cache.py`, whose docstring says it is free of it), and not
    the port's own `chip_smoke.py`."""
    stack = _stack_scripts()
    assert {"build_3sat_cache.py", "diffusion_training.py", "solve_eval.py",
            "__graft_entry__.py"} <= set(stack)
    assert "chip_smoke.py" not in stack
