"""bn_fused_per_call.serve on records built by hand: the counter's mean
over the traced calls, and None without the counter (a program with no
fused BatchNorm), with too few calls or with no recorder."""

import pytest

from port_bench.tests.test_span_readers import read, serve_book

NAME = "bn_fused_per_call.serve"


def counted_book(calls, per_call):
    b = serve_book(calls)
    for unit in range(1, calls + 1):
        b.counts[(unit, "bn_fused")] = per_call
    b.counts[(calls + 1, "bn_fused")] = 99     # a call past the window
    return b


@pytest.mark.parametrize("per_call", [40, 53])
def test_the_counter_per_traced_call(monkeypatch, per_call):
    got = read(monkeypatch, counted_book(4, per_call), NAME, calls_traced=3)
    assert got == pytest.approx(per_call)


def test_no_counter_too_few_calls_or_no_recorder_read_none(monkeypatch):
    assert read(monkeypatch, serve_book(3), NAME, calls_traced=3) is None
    assert read(monkeypatch, counted_book(3, 40), NAME,
                calls_traced=5) is None
    assert read(monkeypatch, None, NAME, calls_traced=3) is None
