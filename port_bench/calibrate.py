#!/usr/bin/env python3
"""Readings that the comparison's limits are set from, for one cell.

    python3 port_bench/calibrate.py --workload <cell> \\
        [--program SEEDS] [--control SEEDS] [--half_batch SEEDS]

SEEDS is a comma-separated list.  ``--program`` runs the cell itself on
each seed (a window of one epoch or one second) and reads its numbers
(the lower readings); ``--control`` and ``--half_batch`` read the
control and the planted fault (``control.py``) at the cell's own size
(the upper readings).  One JSON line per reading; all in one process,
so set-up is paid once per seed and not per process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    for which in ("program", "control", "half_batch"):
        ap.add_argument(f"--{which}", default="")
    args = ap.parse_args(argv)
    from port_bench import control
    from port_bench.run import run_cell, set_cache_dirs
    set_cache_dirs()
    for which in ("program", "control", "half_batch"):
        for seed in filter(None, getattr(args, which).split(",")):
            if which == "program":
                r = run_cell(args.workload, int(seed), 1.0, False,
                             details=True)
                numbers = {k: c["value"] for k, c in r["checks"].items()}
                details = r["details"]
            else:
                numbers, details = control.readings(args.workload,
                                                    int(seed), "cuda", which)
            print(json.dumps({"workload": args.workload, "which": which,
                              "seed": int(seed), "numbers": numbers,
                              "details": details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
