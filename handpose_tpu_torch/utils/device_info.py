"""Device introspection, profiler traces and the build cache.

Port of ``handpose_tpu/utils/device_info.py`` (reference
utils/get_gpu_info.py): the cards ``torch.cuda`` sees with their memory
in use and in all, or the host when there is none; a ``torch.profiler``
trace context; and :func:`enable_compilation_cache`, the counterpart of
JAX's persistent compilation cache.
"""

from __future__ import annotations

import contextlib
import os
import platform
import time
from pathlib import Path
from typing import List

import torch


def get_device_info() -> List[dict]:
    """One dict per card (``id``, ``platform`` 'gpu', ``kind`` its name,
    ``bytes_in_use`` allocated by this process, ``bytes_limit`` its
    memory); without a card one dict for the host."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu",
                 "kind": platform.processor() or platform.machine(),
                 "process": 0}]
    out = []
    for i in range(torch.cuda.device_count()):
        _, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i), "process": 0,
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_limit": total})
    return out


def get_device_utilization_as_string() -> str:
    rows = []
    for info in get_device_info():
        mem = ""
        if info.get("bytes_limit"):
            used = info.get("bytes_in_use") or 0
            mem = (f" mem {used / 2**30:.2f}/"
                   f"{info['bytes_limit'] / 2**30:.2f} GiB")
        rows.append(f"dev{info['id']} {info['platform']}:"
                    f"{info['kind']}{mem}")
    return " | ".join(rows)


def enable_compilation_cache(cache_dir: str) -> None:
    """Build the port's native libraries into ``cache_dir``.

    The port runs eagerly and compiles nothing but its own CUDA and C++
    sources (``ops/cuda_build.py``), so this is what JAX's persistent
    compilation cache becomes: ``nvcc`` and ``g++`` write each library
    into ``cache_dir`` under a name that carries the hash of its source
    and flags, and a warm restart that points here finds them built and
    skips the compilers.  Libraries this process has already loaded stay
    loaded.  An empty ``cache_dir`` leaves the default
    (``build/kernels/`` at the repository root).
    """
    if not cache_dir:
        return
    from ..ops import cuda_build
    cuda_build.BUILD_DIR = Path(cache_dir).resolve()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block, the card's kernels too when
    there is one; on exit a chrome trace
    (``<log_dir>/trace_<time>_<pid>.json``) for chrome://tracing or
    Perfetto."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{int(time.time())}_{os.getpid()}.json"))
