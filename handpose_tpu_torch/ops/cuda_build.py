"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name that carries a hash of the source and of the
compiler flags, so an edited source or flag rebuilds and a finished build
is reused.  Nothing is built at import; the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless it is built.  Returns the
    compiler log (ptxas register and spill report), or None when the
    library was already there; raises with the log when nvcc fails."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}")
    os.replace(tmp, lib)           # atomic: concurrent builders agree
    return res.stdout


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
