"""Spans and counters of the program's phases, on the profiler's clock.

``span(name)`` marks a phase of the program (a ``with`` block) and
``count(name, n)`` counts events inside one, such as the blocking reads of
device values.  They record only while a ``torch.profiler`` session runs:
torch sets ``torch.autograd.profiler._is_profiler_enabled`` for the whole
of every session, whatever activities it traces, and each call reads that
one flag.  With no session running, ``span`` returns a shared context that
does nothing and ``count`` returns at once: nothing is recorded,
allocated, launched or synchronised.

While a session runs, a span

* opens ``torch.profiler.record_function(name)``, so the phase is named in
  the session's trace beside the operations and kernels it holds;
* keeps a :class:`Record`: its name, its parent, its unit, its thread, and
  its host start and end from ``time.time_ns()``, the clock of the trace's
  timestamps (an exported event's ``ts`` plus ``baseTimeNanoseconds`` /
  1000 is microseconds of ``time.time_ns()``);
* on the main thread, once the process has initialised CUDA, records a
  timing event at its start and at its end on the current stream.  The
  events come from a pool; :func:`device_ms` reads the device time
  between two of them when asked, after the work, never on the hot path.

A span named in :data:`UNITS` (a train step, a serve call) opens a unit:
it, the spans inside it and the spans its thread opens after it, until
the next unit, carry its number, and so do the counts made meanwhile.  A
span opened inside an open span of the same name on the same thread is
that span: it records nothing of its own.  Records are kept in memory in
the order they were opened, up to :data:`CAP`; spans and counts past it
are dropped and counted in ``RECORDER.dropped``.

The recorder is one per process (:data:`RECORDER`), since the phases it
names lie deep in the program, where nothing is passed down; readers
take what they need and :meth:`Recorder.clear` empties it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

# the spans that open a unit: one train step, one serve call
UNITS = ("hp.train.step", "hp.serve.call")
# records kept before spans are dropped (a profiled RHD epoch of 161
# steps makes about 1,500)
CAP = 65_536
# timing events the pool makes at a time
EVENT_BLOCK = 256


class Record:
    """One span: ``name``; ``parent``, the index of the enclosing span's
    record (-1 for none); ``unit``, the number of its unit (0 before any);
    ``thread`` (``threading.get_ident()``) and ``main`` (on the main
    thread); ``t0``/``t1``, host start and end in ``time.time_ns()``
    (``t1`` None while open); ``e0``/``e1``, its CUDA timing events (None
    off the main thread or without CUDA); ``i0``/``i1``, the order of its
    start and its end among every start and end recorded."""

    __slots__ = ("name", "parent", "unit", "thread", "main", "t0", "t1",
                 "e0", "e1", "i0", "i1")

    def __init__(self, name, parent, unit, thread, main, t0, e0, i0):
        self.name, self.parent, self.unit = name, parent, unit
        self.thread, self.main = thread, main
        self.t0, self.e0, self.i0 = t0, e0, i0
        self.t1 = self.e1 = self.i1 = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


def device_ms(start, end) -> Optional[float]:
    """Device milliseconds from timing event ``start`` to ``end`` (both
    done), or None where either is missing."""
    if start is None or end is None:
        return None
    return start.elapsed_time(end)


class _EventPool:
    """CUDA timing events, made a block at a time and reused after
    :meth:`Recorder.clear`."""

    def __init__(self):
        self.free: list = []

    def take(self):
        if not self.free:
            self.free = [torch.cuda.Event(enable_timing=True)
                         for _ in range(EVENT_BLOCK)]
        return self.free.pop()

    def give(self, events) -> None:
        self.free.extend(e for e in events if e is not None)


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: list = []            # (index, name) of the open spans
        self.unit = 0                    # the unit this thread is in


class Recorder:
    """The records and counts of the spans that ran under the profiler."""

    def __init__(self):
        self.records: List[Record] = []
        # {(unit, name): events counted}
        self.counts: Dict[tuple, int] = {}
        self.dropped = 0
        self._units = 0
        self._order = 0
        self._lock = threading.Lock()
        self._local = _ThreadState()
        self._events = _EventPool()

    def clear(self) -> None:
        """Forget every record and count; unit numbers start again at 1."""
        with self._lock:
            for r in self.records:
                self._events.give((r.e0, r.e1))
            self.records, self.counts = [], {}
            self.dropped = self._units = self._order = 0

    def _event(self):
        if (threading.current_thread() is not threading.main_thread()
                or not torch.cuda.is_initialized()):
            return None
        ev = self._events.take()
        ev.record()
        return ev

    def _open(self, name: str):
        """(the span's record, its ``record_function``) with both open, or
        None where the span records nothing of its own."""
        local = self._local
        if any(open_name == name for _, open_name in local.stack):
            return None
        with self._lock:
            if len(self.records) >= CAP:
                self.dropped += 1
                return None
            if name in UNITS:
                self._units += 1
                local.unit = self._units
            self._order += 1
            rec = Record(name, local.stack[-1][0] if local.stack else -1,
                         local.unit, threading.get_ident(),
                         threading.current_thread()
                         is threading.main_thread(), None, None, self._order)
            self.records.append(rec)
            local.stack.append((len(self.records) - 1, name))
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        # the phase's own times lie inside its range in the trace
        rec.t0 = time.time_ns()
        rec.e0 = self._event()
        return rec, rf

    def _close(self, opened, exc) -> None:
        rec, rf = opened
        rec.e1 = self._event()
        rec.t1 = time.time_ns()
        rf.__exit__(*exc)
        with self._lock:
            self._order += 1
            rec.i1 = self._order
        self._local.stack.pop()

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            if len(self.records) >= CAP:
                self.dropped += 1
                return
            key = (self._local.unit, name)
            self.counts[key] = self.counts.get(key, 0) + n

    # --- what the readers of a profiled run use ---

    def units(self, name: str) -> List[int]:
        """The indices of the unit spans called ``name``, in order."""
        return [i for i, r in enumerate(self.records) if r.name == name]

    def phases(self, unit: str, n: Optional[int] = None) -> dict:
        """Per unit, over the first ``n`` (default: all) units of span
        ``unit``: {name: {"device_ms", "host_ms"}} of the unit span itself
        and of each span inside one (summed in the unit, then averaged;
        ``device_ms`` None without timing events), and {"count <name>":
        count} for each counter; empty when there is no such unit.  Read
        it once the card has done the work (``torch.cuda.synchronize``)."""
        starts = self.units(unit)[:n]
        if not starts:
            return {}
        ids = {self.records[i].unit for i in starts}
        inside = set(starts)
        sums: Dict[str, list] = {}
        for i, r in enumerate(self.records):
            if r.t1 is None:
                continue
            if i in inside or r.parent in inside:
                inside.add(i)
                d = device_ms(r.e0, r.e1)
                s = sums.setdefault(r.name, [0.0, 0.0])
                s[0] += r.host_ms
                s[1] = None if d is None or s[1] is None else s[1] + d
        out = {name: {"host_ms": h / len(starts),
                      "device_ms": None if d is None else d / len(starts)}
               for name, (h, d) in sums.items()}
        for (u, name), c in self.counts.items():
            if u in ids:
                key = f"count {name}"
                out[key] = out.get(key, 0) + c / len(starts)
        return out


RECORDER = Recorder()


class _Off:
    """The context of a span while no profiler session runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "opened")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.opened = RECORDER._open(self.name)
        return self

    def __exit__(self, *exc):
        if self.opened is not None:
            RECORDER._close(self.opened, exc)
        return False


def span(name: str):
    """A context that records the phase ``name`` while a profiler session
    runs, and otherwise does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current unit while a profiler
    session runs."""
    if _profiler._is_profiler_enabled:
        RECORDER._count(name, n)
