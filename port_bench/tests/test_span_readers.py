"""The span readers (``spans.py`` and the metrics that use it) on records
built by hand: the means they give, the epoch's device time they tile,
and None with too few units or no recorder."""

import pytest

from handpose_tpu_torch.utils.tracing import UNITS, Record
from port_bench import spans
from port_bench.manifest import reader

TRAIN = ["preprocess_span_ms.train", "forward_span_ms.train",
         "backward_span_ms.train", "update_span_ms.train",
         "step_gap_ms.train", "epoch_gap_ms.train", "sync_wait_ms.train",
         "syncs_per_step.train", "collate_ms.train"]
SERVE = ["preprocess_span_ms.serve", "forward_span_ms.serve",
         "preprocess_issue_ms.serve", "forward_issue_ms.serve"]


class Event:
    """A timing event done at ``ms`` on the device."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


class Book:
    """Records as the recorder keeps them, opened and closed in turn;
    times in ms, host ``at`` and device ``dev`` (None: no event)."""

    def __init__(self):
        self.records, self.counts, self.stack = [], {}, []
        self.order = self.unit = 0

    def open(self, name, at, dev=None, main=True):
        if name in UNITS:
            self.unit += 1
        self.order += 1
        self.records.append(Record(
            name, self.stack[-1] if self.stack else -1,
            self.unit if main else 0, 1 if main else 2, main,
            int(at * 1e6), None if dev is None else Event(dev), self.order))
        self.stack.append(len(self.records) - 1)

    def close(self, at, dev=None):
        r = self.records[self.stack.pop()]
        r.t1, r.e1 = int(at * 1e6), None if dev is None else Event(dev)
        self.order += 1
        r.i1 = self.order

    def span(self, name, at, end, dev=None, dev_end=None, main=True):
        self.open(name, at, dev, main)
        self.close(end, dev_end)

    def count(self, name, n):
        key = (self.unit, name)
        self.counts[key] = self.counts.get(key, 0) + n


def train_book(steps=2):
    """An epoch whose first step starts 100 ms (device) after it: each
    step preprocess 10, forward 30, backward 60, update 10 ms, then 5 ms
    idle; host: sync 4 ms and 3 reads a step, collate 7 ms a batch."""
    b = Book()
    b.open("hp.epoch", 0.0, 0.0)
    dev, at = 100.0, 1.0
    for _ in range(steps):
        b.span("hp.data.collate", at, at + 7.0, main=False)
        b.span("hp.data.wait", at, at + 2.0, 50.0, 50.0)
        b.open("hp.train.step", at + 2.0, dev)
        for name, d in (("hp.train.preprocess", 10.0),
                        ("hp.train.forward", 30.0),
                        ("hp.train.backward", 60.0),
                        ("hp.train.update", 10.0)):
            b.span(name, at, at + 1.0, dev, dev + d)
            dev += d
        b.close(at + 6.0, dev)
        b.open("hp.train.sync", at + 6.0, dev)
        b.count("syncs", 3)
        b.close(at + 10.0, dev)
        dev += 5.0
        at += 20.0
    b.close(at, dev)
    return b


def serve_book(calls=3):
    """Calls of preprocessing 12 ms then forward 40 ms on the device,
    issued in 8 and 15 ms of host time."""
    b = Book()
    dev = at = 0.0
    for _ in range(calls):
        b.open("hp.serve.call", at, dev)
        b.span("hp.serve.preprocess", at, at + 8.0, dev, dev + 12.0)
        b.span("hp.serve.forward", at + 8.0, at + 23.0, dev + 12.0,
               dev + 52.0)
        b.close(at + 23.0, dev + 52.0)
        dev += 60.0
        at += 60.0
    return b


def read(monkeypatch, book, name, **ctx):
    monkeypatch.setattr(spans, "recorder", lambda: book)
    kind = name.rsplit(".", 1)[1]
    return reader(name)({"kind": kind, **ctx})


@pytest.mark.parametrize("name,want", zip(
    TRAIN, [10.0, 30.0, 60.0, 10.0, 5.0, 100.0, 4.0, 3.0, 7.0]))
def test_train_readers_give_their_means(monkeypatch, name, want):
    got = read(monkeypatch, train_book(), name, steps_traced=2)
    assert got == pytest.approx(want)


def test_the_train_spans_tile_the_epoch(monkeypatch):
    book = train_book(3)
    got = {n: read(monkeypatch, book, n, steps_traced=3) for n in TRAIN[:6]}
    epoch = book.records[0]
    whole = epoch.e0.elapsed_time(epoch.e1)
    step = sum(got[n] for n in TRAIN[:5])
    assert got["epoch_gap_ms.train"] + 3 * step == pytest.approx(whole)


@pytest.mark.parametrize("name,want", zip(SERVE, [12.0, 40.0, 8.0, 15.0]))
def test_serve_readers_give_their_means(monkeypatch, name, want):
    got = read(monkeypatch, serve_book(), name, calls_traced=3)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_too_few_units_or_no_recorder_read_none(monkeypatch, name):
    train = name.endswith(".train")
    book = train_book() if train else serve_book()
    ctx = {"steps_traced": 3} if train else {"calls_traced": 4}
    assert read(monkeypatch, book, name, **ctx) is None
    assert read(monkeypatch, None, name, **ctx) is None


def test_device_readers_need_the_events(monkeypatch):
    book = train_book()
    for r in book.records:
        r.e0 = r.e1 = None
    assert read(monkeypatch, book, "forward_span_ms.train",
                steps_traced=2) is None
    assert read(monkeypatch, book, "sync_wait_ms.train",
                steps_traced=2) == pytest.approx(4.0)
