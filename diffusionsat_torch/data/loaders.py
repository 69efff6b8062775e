"""File-based instance sources: SPLOT feature models, SATLIB, primes, mixed.

Counterpart of the TPU package's `data/loaders.py`, with the same
splitting and filtering, so both packages yield the same instances from
the same files. With no `data_dir` each loader reads the port's own copy
of the bundled assets (`data/assets/`, written by `make_assets.py`).
"""

from __future__ import annotations

import random
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Iterator

from diffusionsat_torch.data.generators import Instance, SatInstances
from diffusionsat_torch.sat.cnf import CNF


ASSETS_DIR = Path(__file__).resolve().parent / "assets"


class SplotInstances(SatInstances):
    """SPLOT 3-CNF feature-model XMLs (reference data/splot.py:13-97):
    every k-th file is test, the rest train.

    Real SPLOT files name features symbolically (`g_2_2_1 OR ~m_3_1`);
    like the reference's `_line2clause` (data/splot.py:65-77), names map
    to variable ids in order of first appearance and literals are
    '~'-negated. Both ' OR ' (SPLOT's spelling) and ' or ' separators
    are accepted. With no `data_dir`, the bundled synthetic feature
    models under data/assets/splot ship in the same file format so the
    task runs out of the box (the reference bundles data/splot/*.xml)."""

    def __init__(self, data_dir: str | Path | None = None,
                 test_every_k: int = 5, **_ignored):
        self.data_dir = Path(data_dir) if data_dir else ASSETS_DIR / "splot"
        self.test_every_k = test_every_k

    def _files(self) -> list[Path]:
        return sorted(self.data_dir.glob("*.xml"))

    @staticmethod
    def _parse(path: Path) -> tuple[int, list[list[int]]]:
        """Parse <constraints> rules 'id: lit OR lit OR lit' with
        '~'-negated literals; feature names become variable ids in order
        of first appearance (reference data/splot.py:65-77)."""
        root = ET.parse(path).getroot()
        clauses = []
        var_map: dict[str, int] = {}
        for cons in root.iter("constraints"):
            text = cons.text or ""
            for line in text.strip().splitlines():
                line = line.strip()
                if not line or ":" not in line:
                    continue
                body = line.split(":", 1)[1]
                clause = []
                for tok in body.replace(" or ", " OR ").split(" OR "):
                    tok = tok.strip()
                    if not tok:
                        continue
                    neg = tok.startswith("~")
                    name = tok[1:] if neg else tok
                    if name not in var_map:
                        var_map[name] = len(var_map) + 1
                    v = var_map[name]
                    clause.append(-v if neg else v)
                if clause:
                    clauses.append(clause)
        return len(var_map), clauses

    def _generator(self, test: bool) -> Iterator[Instance]:
        for i, f in enumerate(self._files()):
            is_test = (i % self.test_every_k == 0)
            if is_test != test:
                continue
            n_vars, clauses = self._parse(f)
            if clauses:
                yield n_vars, clauses, None

    def train_generator(self):
        return self._generator(test=False)

    def test_generator(self):
        return self._generator(test=True)


class SatLibInstances(SatInstances):
    """.cnf files from a directory (reference data/satlib.py:15-72).
    With no `data_dir`, bundled uf20-91-style instances under
    data/assets/satlib (synthetic SATLIB-format, SAT by construction)."""

    def __init__(self, data_dir: str | Path | None = None,
                 test_fraction: float = 0.1, seed: int = 0, **_ignored):
        self.data_dir = Path(data_dir) if data_dir \
            else ASSETS_DIR / "satlib"
        self.test_fraction = test_fraction
        self.seed = seed

    def _split(self) -> tuple[list[Path], list[Path]]:
        files = sorted(self.data_dir.glob("*.cnf"))
        rng = random.Random(self.seed)
        rng.shuffle(files)
        n_test = max(1, int(len(files) * self.test_fraction)) if files else 0
        return files[n_test:], files[:n_test]

    @staticmethod
    def _load(files) -> Iterator[Instance]:
        for f in files:
            cnf = CNF.load(f)
            if cnf.number_of_clauses():
                yield cnf.number_of_vars(), cnf.clauses(), None

    def train_generator(self):
        return self._load(self._split()[0])

    def test_generator(self):
        return self._load(self._split()[1])


class PrimesInstances(SatLibInstances):
    """Factoring CNFs filtered by variable count (reference
    data/PrimesGen.py:14-103; files in toughsat DIMACS format). With no
    `data_dir`, bundled semiprime instances under data/assets/primes
    (generated from scratch by data/primes_gen.py: an exact Tseitin
    multiplier encoding, instead of the reference's pre-fetched toughsat
    files)."""

    def __init__(self, data_dir: str | Path | None = None,
                 max_vars: int = 1000, **kw):
        kw.pop("min_vars", None)  # CLI forwards it; primes only caps max
        super().__init__(data_dir or ASSETS_DIR / "primes", **kw)
        self.max_vars = max_vars

    @staticmethod
    def _load(files) -> Iterator[Instance]:
        for f in files:
            cnf = CNF.load(f)
            if cnf.number_of_clauses():
                yield cnf.number_of_vars(), cnf.clauses(), None

    def train_generator(self):
        for n, c, s in super().train_generator():
            if n <= self.max_vars:
                yield n, c, s

    def test_generator(self):
        for n, c, s in super().test_generator():
            if n <= self.max_vars:
                yield n, c, s


class MixedInstances(SatInstances):
    """Random mixture over several generators (reference
    data/mixed_sat.py:9-33): round-robin draw from each source's stream.

    With no `sources`, builds the reference MixGraphSAT composition
    (data/mixed_sat.py:15-19): Clique + DomSet + KColor + k-SAT + 3-SAT,
    sized so the combined stream is roughly `train_size`/`test_size`."""

    def __init__(self, sources: list[SatInstances] | None = None,
                 seed: int = 0, min_vars: int = 4, max_vars: int = 20,
                 train_size: int = 10_000, test_size: int = 1_000,
                 **_ignored):
        if sources is None:
            from diffusionsat_torch.data.generators import (
                KSatInstances, SAT3Instances)
            from diffusionsat_torch.data.graph_tasks import (
                CliqueInstances, DomSetInstances, KColorInstances)
            per = max(1, train_size // 5)
            per_t = max(1, test_size // 5)
            mv = max(min_vars, 4)
            sources = [
                CliqueInstances(min_vertices=mv, max_vertices=max_vars,
                                train_size=per, test_size=per_t, seed=seed),
                DomSetInstances(min_vertices=mv,
                                max_vertices=min(max_vars, 12),
                                train_size=per, test_size=per_t, seed=seed),
                KColorInstances(min_vertices=mv, max_vertices=max_vars,
                                train_size=per, test_size=per_t, seed=seed),
                KSatInstances(min_vars=3, max_vars=max(max_vars, 5) * 5,
                              train_size=per, test_size=per_t, seed=seed),
                SAT3Instances(min_vars=5, max_vars=max(max_vars, 5) * 5,
                              train_size=per, test_size=per_t, seed=seed),
            ]
        self.sources = sources
        self.seed = seed

    def _mix(self, gens) -> Iterator[Instance]:
        rng = random.Random(self.seed)
        gens = [iter(g) for g in gens]
        while gens:
            g = rng.choice(gens)
            try:
                yield next(g)
            except StopIteration:
                gens.remove(g)

    def train_generator(self):
        return self._mix([s.train_generator() for s in self.sources])

    def test_generator(self):
        return self._mix([s.test_generator() for s in self.sources])
