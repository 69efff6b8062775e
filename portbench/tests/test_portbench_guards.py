"""What a run refuses: a machine without the card, and a process that
holds JAX or the JAX package once the window has closed."""

import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench import run as run_mod

from _small import small


def test_forbidden_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "optax", "orbax.checkpoint", "diffusionsat_tpu",
             "diffusionsat_tpu.ops", "diffusionsat_torch",
             "diffusionsat_torch.ops.segsum", "jaxtyping", "flaxen",
             "portbench.harness"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
         "orbax.checkpoint", "diffusionsat_tpu", "diffusionsat_tpu.ops"])


def test_a_run_holding_jax_prints_no_result():
    args = types.SimpleNamespace(workload="qs-solve-flat", seed=3,
                                 seconds=0.2, trace=0)
    with pytest.raises(SystemExit) as e:
        run_mod.run(args, device="cpu", overrides=small("qs-solve-flat"),
                    modules=list(sys.modules) + ["jax.numpy"])
    assert e.value.code == 3


def test_the_run_itself_loads_no_jax():
    args = types.SimpleNamespace(workload="qs-solve-flat", seed=3,
                                 seconds=0.2, trace=0)
    code = ("import sys, types\n"
            "from portbench import run, harness\n"
            f"a = types.SimpleNamespace(**{vars(args)!r})\n"
            f"run.run(a, device='cpu', overrides={small('qs-solve-flat')!r})"
            "\nprint(harness.forbidden_modules(list(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """On a machine without CUDA the run exits with code 2 and prints
    nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "anf-train-flat", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 2
    assert res.stdout == ""


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    cannot run a cell."""
    import shutil
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "qs-solve-flat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout == ""
