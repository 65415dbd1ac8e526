"""The port's spans (``utils/tracing.py``) on the card.

* a session that traces the card alone turns the spans on, and each
  phase of a train step gets its device time from its CUDA events; the
  phases tile the step;
* kernel events of an exported trace sit on ``time.time_ns()``'s clock
  (``ts`` + ``baseTimeNanoseconds`` / 1000), as the spans' host times do;
* a ``profile_epoch`` trace holds the ``hp.*`` ranges and the kernels on
  one timeline: K1's launch inside each step's preprocessing range, its
  kernel after it.

Marked ``gpu``; each test skips when no CUDA device is present.  This
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_tracing.py
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from handpose_tpu_torch import Config
from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
from handpose_tpu_torch.infer.evaluator import serving_kwargs
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.train import (Worker, create_train_state,
                                      make_fused_train_step)
from handpose_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu

REC = tracing.RECORDER
B, CROP = 8, 64
PHASES = ("hp.train.preprocess", "hp.train.forward", "hp.train.backward",
          "hp.train.update")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    REC.clear()
    yield torch.device("cuda")
    REC.clear()


@pytest.fixture
def tree(tmp_path):
    root = str(tmp_path / "rhd")
    write_synthetic_rhd(root, "training", n=2 * B, seed=1)
    write_synthetic_rhd(root, "evaluation", n=B, seed=2)
    return root


def _cfg(**kw):
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  batch_size=B, infer_batch_size=B, max_epoch=1,
                  input_img_shape=(CROP, CROP), **kw)


def test_a_card_only_session_times_each_phase(cuda, tree):
    cfg = _cfg()
    model = build_model(cfg).to(cuda)
    state = create_train_state(model, cfg)
    step = make_fused_train_step(model, cfg, None, serving_kwargs(cfg))
    raw = RHDDataset(tree, "training").raw_batch(np.arange(B)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    step(state, raw, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd.profiler._is_profiler_enabled
        for _ in range(3):
            step(state, raw, generator=gen)
        torch.cuda.synchronize()
    phases = REC.phases("hp.train.step")
    whole = phases["hp.train.step"]["device_ms"]
    parts = [phases[p]["device_ms"] for p in PHASES]
    assert whole > 0 and all(p > 0 for p in parts)
    assert 0.9 * whole <= sum(parts) <= 1.001 * whole
    events = {id(e) for r in REC.records for e in (r.e0, r.e1)}
    REC.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        step(state, raw, generator=gen)
        torch.cuda.synchronize()
    assert {id(r.e0) for r in REC.records} <= events    # the pool's again


def test_kernel_events_sit_on_the_host_clock(cuda, tmp_path):
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.span("hp.epoch"):
            torch.cuda.synchronize()
            t0 = time.time_ns() / 1e3
            torch.cuda._sleep(20_000_000)            # ~10 ms of cycles
            torch.cuda.synchronize()
            t1 = time.time_ns() / 1e3
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    (sleep,) = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"
                and "spin_kernel" in e["name"] and e["dur"] > 1000]
    assert t0 - 1e3 <= sleep["ts"] + base
    assert sleep["ts"] + base + sleep["dur"] <= t1 + 1e3
    (span,) = [e for e in trace["traceEvents"] if e["name"] == "hp.epoch"
               and e.get("cat") == "user_annotation"]
    (rec,) = REC.records
    assert abs(span["ts"] + base - rec.t0 / 1e3) <= 1e3
    assert tracing.device_ms(rec.e0, rec.e1) >= 5.0


def test_a_profile_epoch_trace_shows_the_spans_beside_the_kernels(cuda,
                                                                  tree,
                                                                  tmp_path):
    cfg = _cfg(dataset_name="RHD", dataset_root_dir=tree, profile_epoch=0,
               save_log_dir=str(tmp_path / "logs"), steps_per_dispatch=1)
    w = Worker(cfg, device=cuda)
    w.run()
    (name,) = os.listdir(os.path.join(w.run_dir, "profile"))
    with open(os.path.join(w.run_dir, "profile", name)) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in marks} >= set(PHASES) | {
        "hp.epoch", "hp.data.wait", "hp.train.step", "hp.train.sync"}
    k1 = {e["args"]["correlation"]: e for e in events
          if e.get("cat") == "kernel" and "scoremap_" in e["name"]}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in k1]
    prep = [e for e in marks if e["name"] == "hp.train.preprocess"]
    assert len(prep) == 2 == len(k1)
    for p in prep:
        (launch,) = [e for e in launches
                     if p["ts"] <= e["ts"] <= p["ts"] + p["dur"]]
        assert k1[launch["args"]["correlation"]]["ts"] >= launch["ts"]
    assert len(REC.units("hp.train.step")) == 2 and all(
        r.e0 is not None for r in REC.records if r.main)
