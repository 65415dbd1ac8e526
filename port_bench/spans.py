"""What the span readers share: the records of the port's recorder
(``handpose_tpu_torch.utils.tracing``) from a traced run.

The program records its spans and counts only while a profiler session
runs.  A traced run holds one around each of its two traced windows (the
card's activity alone, then the host's operations too); the warm-up, the
untraced epochs or calls and the layer split run with it off.  So the
recorder holds the card-only window first, and a reader takes the first
``steps_traced`` train steps (units of :data:`STEP`) or ``calls_traced``
serve calls (units of :data:`CALL`).  Device times are taken between the
spans' CUDA events, host times from their host clock.  Every reader
returns None where the program has no recorder, or it holds fewer units
than that.
"""

from __future__ import annotations

from typing import List, Optional

from . import readers

STEP, CALL = "hp.train.step", "hp.serve.call"
EPOCH, SYNC, COLLATE = "hp.epoch", "hp.train.sync", "hp.data.collate"


class Window:
    """The first units of one name: the recorder's ``records`` and
    ``counts``, the indices of the unit spans (``starts``), their unit
    numbers (``ids``) and the indices of every span inside one
    (``inside``, the unit spans included)."""

    def __init__(self, recorder, starts: List[int]):
        self.records, self.counts = recorder.records, recorder.counts
        self.starts = starts
        self.ids = {self.records[i].unit for i in starts}
        self.inside = set(starts)
        last = self.records[starts[-1]].i1
        for i in range(starts[0], len(self.records)):
            r = self.records[i]
            if r.i0 > last:
                break
            if r.parent in self.inside:
                self.inside.add(i)

    @property
    def n(self) -> int:
        return len(self.starts)


def recorder():
    """The port's recorder, or None where the port has none."""
    try:
        from handpose_tpu_torch.utils.tracing import RECORDER
    except ImportError:
        return None
    return RECORDER


def window(ctx: dict, unit: str) -> Optional[Window]:
    rec = recorder()
    n = readers.units(ctx)
    if rec is None or n <= 0:
        return None
    starts = [i for i, r in enumerate(rec.records)
              if r.name == unit and r.i1 is not None][:n]
    return Window(rec, starts) if len(starts) == n else None


def _elapsed(start, end) -> Optional[float]:
    if start is None or end is None:
        return None
    return start.elapsed_time(end)


def device_ms(ctx: dict, unit: str, name: str) -> Optional[float]:
    """Device ms between the start and end events of the spans ``name``
    inside the window's units, per unit; None without such a span or
    without events."""
    return _per_unit(ctx, unit, name, lambda r: _elapsed(r.e0, r.e1))


def host_ms(ctx: dict, unit: str, name: str) -> Optional[float]:
    """Host ms inside the spans ``name`` inside the window's units, per
    unit; None without such a span."""
    return _per_unit(ctx, unit, name, lambda r: (r.t1 - r.t0) * 1e-6)


def _per_unit(ctx, unit, name, ms) -> Optional[float]:
    w = window(ctx, unit)
    if w is None:
        return None
    values = [ms(w.records[i]) for i in sorted(w.inside)
              if w.records[i].name == name]
    if not values or None in values:
        return None
    return sum(values) / w.n


def after_unit_ms(ctx: dict, name: str) -> Optional[float]:
    """Host ms per step of the spans ``name`` that follow a step in its
    unit, outside it (the reads of its results); 0 where there are none."""
    w = window(ctx, STEP)
    if w is None:
        return None
    return sum((r.t1 - r.t0) * 1e-6 for i, r in enumerate(w.records)
               if r.name == name and r.unit in w.ids and i not in w.inside
               and r.t1 is not None) / w.n


def count_per_step(ctx: dict, name: str) -> Optional[float]:
    """Counter ``name`` per step over the window's units; 0 where it
    counted nothing."""
    w = window(ctx, STEP)
    if w is None:
        return None
    return sum(c for (u, k), c in w.counts.items()
               if k == name and u in w.ids) / w.n


def step_gap_ms(ctx: dict) -> Optional[float]:
    """Device ms from each step's end event to the next event of a step's
    start or an epoch's end, per step."""
    w = window(ctx, STEP)
    if w is None:
        return None
    marks = sorted([(r.i0, r.e0) for r in w.records if r.name == STEP]
                   + [(r.i1, r.e1) for r in w.records
                      if r.name == EPOCH and r.i1 is not None],
                   key=lambda m: m[0])
    gaps = []
    for i in w.starts:
        r = w.records[i]
        nxt = next((e for order, e in marks if order > r.i1), None)
        if nxt is None:
            continue
        gaps.append(_elapsed(r.e1, nxt))
    if not gaps or None in gaps:
        return None
    return sum(gaps) / len(gaps)


def epoch_gap_ms(ctx: dict) -> Optional[float]:
    """Device ms from the start event of each epoch that holds a step of
    the window to its first step's start event, per epoch."""
    w = window(ctx, STEP)
    if w is None:
        return None
    gaps = []
    for r in w.records:
        if r.name != EPOCH or r.i1 is None:
            continue
        first = [w.records[i] for i in w.starts
                 if r.i0 < w.records[i].i0 < r.i1]
        if first:
            gaps.append(_elapsed(r.e0, first[0].e0))
    if not gaps or None in gaps:
        return None
    return sum(gaps) / len(gaps)


def collate_ms(ctx: dict) -> Optional[float]:
    """Host ms of each of the first ``steps_traced`` batches' collation
    (the data pipeline's thread), per batch."""
    rec = recorder()
    n = readers.units(ctx)
    if rec is None or n <= 0:
        return None
    spans = [r for r in rec.records
             if r.name == COLLATE and r.t1 is not None][:n]
    if len(spans) < n:
        return None
    return sum((r.t1 - r.t0) * 1e-6 for r in spans) / n
