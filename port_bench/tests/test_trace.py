"""The idle share is 1 - the union of device intervals over the window,
on made-up intervals and a made-up trace."""

import json

import pytest

from port_bench import trace


def test_union_merges_overlaps_and_touching():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert trace.covered([(0, 10), (2, 3), (9, 12)]) == 12


def test_gaps_inside_the_window():
    assert trace.gaps([(2, 4), (3, 5), (8, 9)], 0, 10) == [
        (0, 2), (5, 8), (9, 10)]
    assert trace.gaps([(-5, 20)], 0, 10) == []


def _events():
    win = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 1000, "dur": 1000}
    kernels = [("scoremap_vec4_kernel", 1000, 100),
               ("moments_partial_kernel<bf16>", 1050, 100),   # overlaps
               ("gemm", 1400, 200),
               ("moments_final_kernel", 1900, 200)]           # ends outside
    ev = [win] + [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
                  for n, t, d in kernels]
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 1620, "dur": 30})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 1150, "dur": 300})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::item",
               "ts": 1640, "dur": 100})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "outer",
               "ts": 1000, "dur": 900})
    return ev


def test_busy_idle_and_kernels(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    tr = trace.Trace.load(str(path))
    # busy: [1000, 1150] + [1400, 1600] + [1620, 1650] + [1900, 2000]
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(480e-6)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(52.0)
    secs, n = tr.kernel_seconds(("moments_partial_kernel",
                                 "moments_final_kernel"))
    assert n == 2 and secs == pytest.approx(300e-6)
    top = tr.top_ops(2)
    assert top[0][0] == "gemm" and top[0][1] == pytest.approx(200e-6)
    gaps = tr.idle_gaps(3)
    assert [g[1] for g in gaps] == pytest.approx([250e-6, 250e-6, 20e-6])
    # the innermost host event running when each gap began
    assert [g[0] for g in gaps] == ["aten::copy_", "aten::item", "outer"]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError, match="window"):
        trace.Trace([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                      "dur": 1}])


def test_a_gap_in_unprofiled_host_code_names_what_it_followed():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 5,
           "dur": 4},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 40}]
    assert trace.Trace(ev).idle_gaps() == [
        ["host code after aten::item", pytest.approx(50e-6)]]


def test_marks_bound_the_window_and_are_not_busy():
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [{"ph": "X", "cat": "kernel", "name": mark, "ts": 100, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "early", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": mark, "ts": 299, "dur": 1}]
    tr = trace.Trace(ev)
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    assert [op[0] for op in tr.top_ops()] == ["k"]


def test_a_trace_without_its_window_is_taken_again(monkeypatch, tmp_path):
    load, missed, runs = trace.Trace.load, [], []

    def flaky(path):
        if not missed:
            missed.append(path)
            raise trace.NoWindow("the trace has no window")
        return load(path)
    monkeypatch.setattr(trace.Trace, "load", staticmethod(flaky))
    tr, value = trace.profile(lambda: runs.append(1) or len(runs),
                              str(tmp_path))
    assert runs == [1, 1] and value == 2 and tr.window_s > 0
    assert list(tmp_path.iterdir()) == []
