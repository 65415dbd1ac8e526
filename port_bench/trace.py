"""The profiler's trace of a window, read as intervals.

A traced window runs under ``torch.profiler``.  On the card it is
bounded by two marks: a tiny kernel of :data:`MARK` on the idle device
before the window's work, and another after it and a device
synchronisation.  The numbers come from a trace of the card's activity
alone, so that the profiler's cost per host operation does not stretch
the idle time; a second trace of the same work with the host's
operations recorded labels the idle gaps.  Off the card (the harness's
own tests) the window is a ``record_function`` range named
:data:`WINDOW`.  A trace is exported as Chrome JSON, read back and
reduced to:

* the device's busy time: the union of its kernel, copy and set
  intervals inside the window (overlapping work counts once), and the
  idle share that is left;
* the summed time of the kernels whose names match a pattern;
* the device operations that took the most time, and the longest idle
  gaps, each labelled with the innermost host event running when it
  began (or, where the host ran unprofiled Python, the event it
  followed).
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

WINDOW = "port_bench.window"
# the kernel of torch.cuda._sleep, which marks the window on the card
MARK = "spin_kernel"
MARK_CYCLES = 1000
# a card-only trace now and then comes back without its marks (one of
# ten traced runs on an H100): the window is then run and traced again
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, merged intervals: their union."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def covered(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class NoWindow(ValueError):
    """A trace that holds neither the marks nor the window's range."""


class Trace:
    """The events of one traced window; times in microseconds."""

    def __init__(self, events: list):
        device = [(e["name"], float(e["ts"]), float(e["ts"])
                   + float(e.get("dur", 0))) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = sorted((a, b) for n, a, b in device if MARK in n)
        spans = [e for e in events if e.get("name") == WINDOW
                 and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if len(marks) >= 2:
            self.lo, self.hi = marks[0][0], marks[-1][1]
        elif spans:
            w = spans[0]
            self.lo = float(w["ts"])
            self.hi = self.lo + float(w["dur"])
        else:
            raise NoWindow(f"the trace has no window: neither two "
                             f"{MARK!r} marks nor a {WINDOW!r} range")
        self.device = [(n, a, b) for n, a, b in device if MARK not in n
                       and b > self.lo and a < self.hi]
        self.host = [(e["name"], float(e["ts"]), float(e["ts"])
                      + float(e.get("dur", 0))) for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return covered(clip([(a, b) for _, a, b in self.device],
                            self.lo, self.hi)) * 1e-6

    def kernel_seconds(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """(summed device time, launches) of the kernels whose name holds
        any of ``patterns``."""
        hits = [(a, b) for n, a, b in self.device
                if any(p in n for p in patterns)]
        return sum(b - a for a, b in hits) * 1e-6, len(hits)

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, a, b in self.device:
            by[n] += (min(b, self.hi) - max(a, self.lo)) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps as [what the host was doing, s]."""
        longest = sorted(gaps([(a, b) for _, a, b in self.device], self.lo,
                              self.hi), key=lambda g: g[0] - g[1])[:k]
        out = []
        for a, b in longest:
            live = [(s, n) for n, s, e in self.host if s <= a < e]
            if live:
                label = max(live)[1]
            else:
                # Python between profiled calls: name what it followed
                done = [(e, n) for n, s, e in self.host if e <= a]
                label = f"host code after {max(done)[1]}" if done \
                    else "host code"
            out.append([label, (b - a) * 1e-6])
        return out


def profile(fn, workdir: str, host: bool = False):
    """(the trace, what ``fn`` returned) of ``fn()`` under the profiler:
    on the card between two marks, the card's activity alone, or with
    ``host`` the host's operations too; off the card the host alone,
    inside the :data:`WINDOW` range.  A trace without its window is taken
    again, ``fn()`` with it, up to :data:`ATTEMPTS` times.  The trace
    file is read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_, \
        record_function

    on_card = torch.cuda.is_available()
    if on_card:
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                          else [])
    else:
        acts = [ProfilerActivity.CPU]

    def mark():
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)

    path = os.path.join(workdir, "trace.json")
    for attempt in range(1, ATTEMPTS + 1):
        with prof_(activities=acts) as prof:
            with record_function(WINDOW):
                if on_card:
                    mark()
                value = fn()
                if on_card:
                    mark()
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        try:
            return Trace.load(path), value
        except NoWindow:
            if attempt == ATTEMPTS:
                raise
            print(f"port_bench: trace {attempt} of {ATTEMPTS} has no "
                  "window; tracing again", file=sys.stderr, flush=True)
        finally:
            os.remove(path)
