"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name that carries a hash of the source and of the
compiler flags, so an edited source or flag rebuilds and a finished build
is reused.  Nothing is built at import; the first launch builds, or
:func:`build_many` builds several sources at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

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


def build_many(names) -> Dict[str, Optional[str]]:
    """Compile each ``csrc/<name>.cu`` that is not built, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler log}``
    (the ptxas register and spill report; None for a library that was
    already there); raises with the log of the first source that fails.
    """
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs: Dict[str, Optional[str]] = {name: None for name in names}
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(name)
        else:
            os.replace(tmp, lib)       # atomic: concurrent builds agree
    if failed:
        raise RuntimeError(f"nvcc failed for {failed[0]}.cu:\n"
                           f"{logs[failed[0]]}")
    return logs


def vector_width(*tensors) -> int:
    """Elements along dim 1 (C) that a kernel thread loads at once: the
    widest of 16, 8, 4 or 2 bytes (down to one element) that divides C
    and every tensor's base address."""
    esize = tensors[0].element_size()
    C = tensors[0].shape[1]
    vec = 16 // esize
    while vec > 1 and (C % vec or any(t.data_ptr() % (vec * esize)
                                      for t in tensors)):
        vec //= 2
    return vec


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    build_many([name])
    return ctypes.CDLL(str(library_path(name)))
