"""What every cell shares: finding files by name, spans and counters, the
device trace, the checks on the machine and on the process, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

- `configs/<config>.json`: the configuration as it is run;
- `reference/<config>.py`: its plain reference;
- `flops/<config>.py`: the useful operations of its steps;
- `traffic/<traffic>.json`: the mix's parameters, with the `driver` that
  runs it (`drivers/<driver>.py`);
- `metrics/<metric>.py`: a per-layer metric's reader, `read(run)`.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# modules the process that prints the result must not hold: the JAX
# package, JAX and its libraries, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffusionsat_tpu")


def set_cache_dirs() -> None:
    """Build and kernel caches in fixed directories inside the checkout,
    so that only the first run of a checkout compiles."""
    cache = PKG / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((PKG / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold '-' and
    '.')."""
    key = f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, PKG / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def forbidden_modules(names) -> list[str]:
    """The module names among `names` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def peaks() -> dict:
    return json.loads((PKG / "peaks.json").read_text())


class Record:
    """Host spans and counters of one run, kept in memory. Spans are also
    written into the device trace while it records (as `pb:<name>`)."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.counters: dict = {}
        self.tracing = False
        self.trace = None           # Trace of the traced stretch

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.tracing:
            import torch
            ctx = torch.profiler.record_function(f"pb:{name}")
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)


class Trace:
    """Kernel intervals and host spans of one traced stretch, in ns on the
    profiler's clock."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType

        self.kernels, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith("pb:"):
                # the span's own range also shows on the device's timeline
                if e.device_type() != DeviceType.CUDA:
                    self.host.append((e.name()[3:], e.start_ns(),
                                      e.start_ns() + e.duration_ns()))
            elif e.device_type() == DeviceType.CUDA:
                self.kernels.append((e.name(), e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
        self.kernels.sort(key=lambda k: k[1])
        self.window_s = wall_s

    def busy_intervals(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, a, b in self.kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict[str, int] = {}
        for name, a, b in self.kernels:
            by_name[name] = by_name.get(name, 0) + b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy[:-1], busy[1:])
                if b0 > a1]
        gaps.sort(key=lambda g: g[0] - g[1])

        def doing(t):
            inner = [h for h in self.host if h[1] <= t <= h[2]]
            if not inner:
                return "host outside the benchmark's spans"
            return min(inner, key=lambda h: h[2] - h[1])[0]

        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": [[doing((a + b) // 2), (b - a) / 1e9]
                              for a, b in gaps[:n]]}


@contextlib.contextmanager
def traced_stretch(rec: Record, sync):
    """Profile device kernels and the benchmark's host spans over the
    body; the stretch starts and ends on a device sync."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rec.tracing = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            wall = time.perf_counter() - t0
            rec.tracing = False
    rec.trace = Trace(prof, wall)


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
