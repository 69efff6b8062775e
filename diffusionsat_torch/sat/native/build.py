"""Build the native solver shared library with g++ at first use.

The library goes into `_build/` beside the package, under a name keyed by a
hash of the source and the compiler flags, so a changed source is rebuilt
and nothing is ever written beside the source.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "solver.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
# -march=native as the TPU package builds its copy, so that on one machine
# both libraries are the same code
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-march=native")


def build() -> Path:
    """Path of the built library, compiling it if this source version has
    not been built yet. Raises if there is no g++ or the compile fails."""
    tag = hashlib.sha1(SOURCE.read_bytes() +
                       " ".join(CXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libdsat_{tag[:16]}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: a C++ compiler is needed to "
                           "build the native SAT solver")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds agree
    return so


if __name__ == "__main__":
    print(build())
