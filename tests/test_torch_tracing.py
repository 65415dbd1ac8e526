"""The port's spans and counters (``utils/tracing.py``) on the host.

* torch's profiler switch, ``torch.autograd.profiler._is_profiler_enabled``,
  is a plain bool that every ``torch.profiler`` session sets while it runs;
* with no session, a span is one shared context and records nothing; a
  fake-data Worker epoch and a ``serve`` call leave the recorder empty and
  give, bit for bit, what they give under a session;
* under a session each train step is one unit whose ``hp.train.*``
  children come in order and nested, on every path the Worker drives
  (fused, ``fuse_preprocess=False``, ``steps_per_dispatch`` groups,
  ``grad_accum``); ``syncs`` counts each blocking read of
  ``_finish_train_metrics``; the ``hp.*`` names are ``user_annotation``
  events of the exported trace, each span's host times inside its range
  there; a serve call is one unit of preprocessing then forward;
* the recorder's own rules: a span inside one of the same name, spans of
  another thread, the cap, ``clear``.
"""

import json
import shutil
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
from handpose_tpu_torch.infer.serving import load_serving_model, serve
from handpose_tpu_torch.train import Worker
from handpose_tpu_torch.utils import tracing

from _torch_port import port_worker_niced  # noqa: F401  (one torch thread, niced)

N, BATCH, CROP = 6, 2, 32
REC = tracing.RECORDER
STEP = ["hp.train.preprocess", "hp.train.forward", "hp.train.backward",
        "hp.train.update"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "training", n=N, seed=5)
    write_synthetic_rhd(root, "evaluation", n=BATCH, seed=6)
    return root


@pytest.fixture(autouse=True)
def empty_recorder():
    REC.clear()
    yield
    REC.clear()


@pytest.fixture
def logs(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(logs, **kw):
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  batch_size=BATCH, infer_batch_size=BATCH, max_epoch=1,
                  input_img_shape=(CROP, CROP), compute_dtype="float32",
                  save_log_dir=str(logs), **kw)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _variables(worker):
    return export_flax_variables(worker.model)


def test_the_profiler_switch_is_a_bool_each_session_sets():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_a_span_without_the_profiler_is_one_shared_context():
    a, b = tracing.span("hp.train.step"), tracing.span("hp.epoch")
    assert a is b
    with a:
        tracing.count("syncs", 3)
    assert REC.records == [] and REC.counts == {} and REC.dropped == 0


def test_profiler_off_records_nothing_and_changes_no_result(logs, tree):
    fake = _cfg(logs, use_fake_data=True, dataset_name="synthetic",
                log_every_steps=0)
    off, on = Worker(fake, device="cpu"), Worker(fake, device="cpu")
    off.run_epoch(0, "training", fast_debug=True)
    assert REC.records == [] and REC.counts == {}
    _profiled(lambda: on.run_epoch(0, "training", fast_debug=True))
    assert len(REC.units("hp.train.step")) == 3
    a, b = _variables(off), _variables(on)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    REC.clear()
    cfg = _cfg(logs)
    model = load_serving_model(cfg, device="cpu")
    raw = RHDDataset(tree, "evaluation").raw_batch(np.arange(BATCH))
    xyz, uv = serve(model, raw, cfg, device="cpu")
    assert REC.records == []
    _, (xyz2, uv2) = _profiled(lambda: serve(model, raw, cfg, device="cpu"))
    assert torch.equal(xyz, xyz2) and torch.equal(uv, uv2)
    (call,) = REC.units("hp.serve.call")
    assert [r.name for r in REC.records if r.parent == call] == [
        "hp.serve.preprocess", "hp.serve.forward"]


def _children(i):
    return [j for j, r in enumerate(REC.records) if r.parent == i]


# a group's losses are read after its last step, in that step's unit
@pytest.mark.parametrize("path,kw,expect,read_in", [
    ("fused", {}, STEP, [1, 2, 3]),
    ("unfused", {"fuse_preprocess": False}, STEP, [1, 2, 3]),
    ("groups", {"steps_per_dispatch": 2}, STEP, [2, 2, 3]),
    ("grad_accum", {"grad_accum": 2},
     STEP[:3] * 2 + ["hp.train.backward", "hp.train.update"], [1, 2, 3]),
])
def test_each_step_is_one_unit_of_its_phases(tree, logs, monkeypatch, path,
                                             kw, expect, read_in):
    cfg = _cfg(logs, dataset_name="RHD", dataset_root_dir=tree,
               **{"steps_per_dispatch": 1, **kw})
    worker = Worker(cfg, device="cpu")
    reads = []
    to_float = torch.Tensor.__float__

    def counted(t):
        stack = REC._local.stack
        reads.append(bool(stack) and stack[-1][1] == "hp.train.sync")
        return to_float(t)

    monkeypatch.setattr(torch.Tensor, "__float__", counted)
    prof, _ = _profiled(lambda: worker.run_epoch(0, "training"))
    monkeypatch.undo()

    steps = REC.units("hp.train.step")
    assert len(steps) == N // BATCH == worker.state.step
    assert [REC.records[i].unit for i in steps] == [1, 2, 3]
    (epoch,) = REC.units("hp.epoch")
    for i in steps:
        step = REC.records[i]
        assert step.parent == epoch and step.main
        kids = [REC.records[j] for j in _children(i)]
        assert [k.name for k in kids] == expect
        assert all(k.unit == step.unit for k in kids)
        order = [step.i0] + [x for k in kids for x in (k.i0, k.i1)] \
            + [step.i1]
        assert order == sorted(order)          # in turn, inside the step
        assert all(step.t0 <= k.t0 <= k.t1 <= step.t1 for k in kids)
    syncs = [r for r in REC.records if r.name == "hp.train.sync"]
    assert [r.unit for r in syncs] == read_in
    assert sum(REC.counts.values()) == sum(reads) > 0 and all(reads)
    assert set(REC.counts) == {(u, "syncs") for u in read_in}
    waits = [r for r in REC.records if r.name == "hp.data.wait"]
    assert len(waits) == len(steps) + 1 and all(r.parent == epoch
                                                for r in waits)
    collates = [r for r in REC.records if r.name == "hp.data.collate"]
    assert len(collates) == len(steps) and not any(r.main for r in collates)

    path_ = logs / "trace.json"
    prof.export_chrome_trace(str(path_))
    with open(path_) as f:
        trace = json.load(f)
    marks = [e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("hp.")]
    assert {e["name"] for e in marks} >= set(expect) | {
        "hp.epoch", "hp.data.wait", "hp.train.step", "hp.train.sync"}
    if path == "fused":
        # the trace's clock: ts + baseTimeNanoseconds / 1000 is
        # microseconds of time.time_ns(); each span lies in its range
        base = trace.get("baseTimeNanoseconds", 0) / 1e3
        ranges = sorted((e["ts"] + base, e["ts"] + base + e["dur"], e["name"])
                        for e in marks)
        mine = sorted((r.t0 / 1e3, r.t1 / 1e3, r.name) for r in REC.records
                      if r.main)
        assert [n for *_, n in ranges] == [n for *_, n in mine]
        for (a, b, _), (t0, t1, _) in zip(ranges, mine):
            assert a - 1e3 <= t0 <= t1 <= b + 1e3


def test_the_recorders_rules(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("hp.serve.call"):
            with tracing.span("hp.serve.call"):     # the same span
                tracing.count("syncs")
            with tracing.span("hp.serve.forward"):
                pass
        done = []
        thread = threading.Thread(target=lambda: done.append(
            tracing.span("hp.data.collate").__enter__().__exit__(
                None, None, None)))
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive() and done == [False]
        tracing.count("syncs", 2)
    names = [(r.name, r.unit, r.parent) for r in REC.records]
    assert names == [("hp.serve.call", 1, -1), ("hp.serve.forward", 1, 0),
                     ("hp.data.collate", 0, -1)]
    collate = REC.records[2]
    assert not collate.main and collate.e0 is None and collate.e1 is None
    assert REC.counts == {(1, "syncs"): 3} and REC._local.stack == []
    phases = REC.phases("hp.serve.call")
    assert set(phases) == {"hp.serve.call", "hp.serve.forward",
                           "count syncs"}
    assert phases["count syncs"] == 3 and phases[
        "hp.serve.forward"]["device_ms"] is None

    REC.clear()
    monkeypatch.setattr(tracing, "CAP", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            with tracing.span("hp.epoch"):
                pass
        tracing.count("syncs")
    assert len(REC.records) == 2 and REC.dropped == 3
    REC.clear()
    assert REC.records == [] and REC.dropped == 0 and REC.counts == {}
