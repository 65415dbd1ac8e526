"""Serving cells: ``infer/serving.py::serve`` on the ``is_inference``
model from ``load_serving_model``.

Set-up makes a pool of ``pool`` distinct raw batches of ``batch``
samples on the card from the seed (no disk), builds the model on the
seed's weights and makes ``warm_calls`` calls.  The window is a closed
loop of one client (``in_flight`` 1): each call is issued on the next
pool batch as soon as the previous call's outputs are ready on the
card, for ``--seconds``; a call's latency runs from its issue to its
outputs ready.  Every call's outputs are kept and, after the window,
compared with the reference on its batch.  A traced run instead makes
``traced_calls`` calls untraced (the host's issue time and the rate),
the layer split, ``traced_calls`` calls under the profiler tracing the
card alone, and as many with the host's operations traced too.
"""

from __future__ import annotations

import math
import time

import torch

from .. import correct, inputs, reference, trace as trace_
from ..reference import synth, train as ref_train
from .common import (Job, Outcome, card_state, event_ms, free, host_line,
                     host_load, nearest_rank, peak_bytes, phase, port_config,
                     spread_line, sync)


def run(job: Job) -> Outcome:
    from handpose_tpu_torch.data.preprocess import RawBatch, \
        preprocess_fn_for
    from handpose_tpu_torch.infer import serving
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    t, c, dev = job.traffic, job.config, job.device
    if t["in_flight"] != 1:
        raise ValueError("the serve driver runs one call in flight")
    P, B = t["pool"], t["batch"]
    samples, cuts, weights0 = inputs.serve(c, t, job.seed, dev)
    pool = [RawBatch(*synth.raw_fields(samples, s)) for s in cuts]
    free(dev)
    phase("inputs made", job)
    cfg = port_config(job)
    model = serving.load_serving_model(cfg, weights=weights0, device=dev)
    phase("the model built", job)
    for i in range(t["warm_calls"]):
        serving.serve(model, pool[i % P], cfg, device=dev)
    sync(dev)
    phase(f"{t['warm_calls']} warm calls", job)

    outputs, latency, issue = [], [], []

    def calls(count: int = 0, seconds: float = 0.0) -> float:
        t0 = time.perf_counter()
        n = 0
        while (n < count) if count else (time.perf_counter() - t0 < seconds):
            a = time.perf_counter()
            xyz, uv = serving.serve(model, pool[len(outputs) % P], cfg,
                                    device=dev)
            b = time.perf_counter()
            sync(dev)
            latency.append(time.perf_counter() - a)
            issue.append(b - a)
            outputs.append((len(outputs) % P, xyz, uv))
            n += 1
        return time.perf_counter() - t0

    out = Outcome()
    if not job.trace:
        before, load0 = card_state(dev), host_load()
        t0 = time.perf_counter()
        secs = calls(seconds=job.seconds)
        out.measured = {"serve_img_per_s": len(outputs) * B / secs,
                        "serve_p95_ms": nearest_rank(latency, 0.95) * 1e3,
                        "setup_s": t0 - job.t_start}
        phase(f"the window ({spread_line('calls', latency)}; "
              f"{spread_line('issue', issue)}; the card before and after: "
              f"{before} | {card_state(dev)}; {host_line(load0, host_load())})",
              job, t0)
    else:
        secs = calls(count=t["traced_calls"])
        rate, host_ms = len(outputs) * B / secs, sum(issue) / len(issue)
        prep_fn = preprocess_fn_for(pool[0])
        pp = serving_kwargs(cfg)

        def prep():
            with torch.inference_mode():
                return prep_fn(pool[0], **pp)

        prep_ms = event_ms(prep, 10, dev)
        serve_ms = event_ms(lambda: serving.serve(model, pool[0], cfg,
                                                  device=dev), 10, dev)
        out.trace, _ = trace_.profile(
            lambda: calls(count=t["traced_calls"]), job.workdir)
        out.host_trace, _ = trace_.profile(
            lambda: calls(count=t["traced_calls"]), job.workdir, host=True)
        out.context = {"split": {"preprocess_ms": prep_ms,
                                 "forward_ms": serve_ms - prep_ms,
                                 "serve_ms": serve_ms},
                       "host_issue_ms": host_ms * 1e3,
                       "calls_traced": t["traced_calls"],
                       "images_per_s": rate}
    out.attempted = len(outputs)
    out.memory_peak_bytes = peak_bytes(dev)
    got = [(i, xyz.cpu().numpy(), None if uv is None else uv.cpu().numpy())
           for i, xyz, uv in outputs]
    out.failed = sum(1 for _, xyz, uv in got
                     if uv is None or not (math.isfinite(xyz.sum())
                                           and math.isfinite(uv.sum())))
    del model, outputs
    free(dev)
    t0 = time.perf_counter()
    out.numbers = check(c, samples, cuts, weights0, dev, got)
    phase("the reference's pool", job, t0)
    return out


def by_reference(config: dict, samples: dict, cuts, weights0: dict, device,
              quant=None) -> list:
    """The reference's (xyz, uv) of each pool batch, host arrays;
    ``quant`` makes it the control."""
    net = reference.module(config)
    w = {k: torch.from_numpy(v).to(device) for k, v in weights0.items()}
    out = []
    for s in cuts:
        xyz, uv = ref_train.serve(net, w, synth.raw_fields(samples, s),
                                  config, quant)
        out.append((xyz.cpu().numpy(), uv.cpu().numpy()))
    return out


def check(config: dict, samples: dict, cuts, weights0: dict, device,
          got: list) -> dict:
    """The comparison's numbers of ``got`` ((pool index, xyz, uv) of each
    call) against the reference on its pool batch."""
    return correct.serve_numbers(got, by_reference(config, samples, cuts,
                                                weights0, device))
