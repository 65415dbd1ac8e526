#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

(or ``python3 -m port_bench.run ...``) from the repository root.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the reference, beside its limit, which also close standard error.

Exits non-zero with no result line when no CUDA card is present (or
fewer than the cell asks for), when the measured package cannot be
imported, or when, after the window, a module of JAX, jaxlib, flax or
the JAX package ``handpose_tpu`` is loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "handpose_tpu")
# torch's intra-op threads on the host
HOST_THREADS = 1
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def set_cache_dirs(root: Path = ROOT) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "port_bench" / sub)


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot,
    compared whole) is in :data:`FORBIDDEN`."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(tops & set(FORBIDDEN))


def _number(v):
    return v if math.isfinite(v) else str(v)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             config_overrides: dict = None,
             traffic_overrides: dict = None,
             t_start: float = None, details: bool = False) -> dict:
    """The result object of one run of cell ``name``.  ``device`` "cpu"
    and the overrides serve the harness's own tests; ``details`` adds
    what the calibration reads beside the numbers compared."""
    import importlib

    import torch

    from port_bench import correct
    from port_bench.drivers.common import Job
    from port_bench.manifest import Manifest, reader

    manifest = Manifest.load(root)
    cell = manifest.cell(name)
    config = {**manifest.config(cell["config"]), **(config_overrides or {})}
    traffic = {**manifest.traffic(cell["traffic"]),
               **(traffic_overrides or {})}
    dev = torch.device(device)
    driver = importlib.import_module(f"port_bench.drivers.{traffic['kind']}")
    workdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        outcome = driver.run(Job(cell=name, config=config, traffic=traffic,
                                 seed=seed, seconds=seconds, trace=trace,
                                 device=dev, workdir=workdir,
                                 t_start=T_START if t_start is None
                                 else t_start))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if not trace:
        for m in manifest.end_to_end(name):
            if m["name"] in outcome.measured:
                metrics[m["name"]] = {"value": outcome.measured[m["name"]],
                                      "unit": m["unit"]}
    else:
        context = {**outcome.context, "kind": traffic["kind"],
                   "config": config, "traffic": traffic,
                   "trace": outcome.trace}
        for m in manifest.per_layer(name):
            value = reader(m["name"])(context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = dev.type == "cuda"
    result = {"attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": outcome.memory_peak_bytes}}
    if trace:
        tr, host = outcome.trace, outcome.host_trace or outcome.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        # the gaps as the host saw them: their labels need its operations
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": host.idle_gaps()}
        print(f"port_bench: idle share {100 * (1 - tr.busy_s / tr.window_s)}"
              f" % tracing the card alone, "
              f"{100 * (1 - host.busy_s / host.window_s)} % with the host's "
              "operations traced", file=sys.stderr)
    ok, checks = correct.judge(outcome.numbers,
                               config["limits"][traffic["kind"]])
    result["correct"] = ok and outcome.failed == 0
    result["checks"] = {k: {"value": _number(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks")
    out = {k: result[k] for k in order if k in result}
    if details:
        out["details"] = outcome.details
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    from port_bench.manifest import Manifest
    chips = Manifest.load().cell(args.workload)["chips"]
    import torch
    # one host thread for the CPU's own tensor work (the pinned copy of a
    # batch): the main thread issues the card's work and shares the host
    torch.set_num_threads(HOST_THREADS)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); {have} "
              "available", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of {found} are loaded in this process",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
