"""Benchmark result store for uniformity experiments.

Counterpart of the TPU package's `uniformity/benchmarks_file.py`, with
the same key and JSON-lines schema, so `uniformity_report.py` reads the
files of either package. Replaces the reference's UnQLite document store
(`satuniformity/BenchmarksFile.py:5-59`): records are keyed by the SHA-256
of the canonicalized clause list and persisted as JSON lines.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Sequence


def formula_key(clauses: Sequence[Sequence[int]]) -> str:
    canon = json.dumps([[int(x) for x in c] for c in clauses])
    return hashlib.sha256(canon.encode()).hexdigest()


class BenchmarksFile:
    def __init__(self, path: str | Path = "benchmarks.jsonl"):
        self.path = Path(path)

    def write(self, clauses: Sequence[Sequence[int]], record: dict[str, Any]
              ) -> None:
        rec = {"key": formula_key(clauses), **record}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    def read_all(self) -> list[dict]:
        if not self.path.exists():
            return []
        with self.path.open() as f:
            return [json.loads(line) for line in f if line.strip()]

    def find(self, clauses: Sequence[Sequence[int]]) -> list[dict]:
        key = formula_key(clauses)
        return [r for r in self.read_all() if r.get("key") == key]
