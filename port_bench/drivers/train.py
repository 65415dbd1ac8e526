"""Training cells: the port's ``Worker`` over an RHD tree made from the
seed.

Set-up writes the tree (``samples`` training images and
``eval_samples`` evaluation images, which the Worker opens and never
runs in the window), builds the Worker on the seed's weights, and runs
``warm_epochs`` epochs through ``Worker.run_epoch``: the window's own
call and feed.  Its first ``checked_steps`` steps are watched as they
pass: the rows they train on, their losses, Adam's first moment after
the first step and the parameters after the last.  The window runs
whole epochs until ``--seconds`` have passed: every image trained over
the whole window's time.  A traced run instead runs ``traced_epochs``
epochs untimed by the profiler (the input wait and the whole-step
rate), the layer split, one epoch under the profiler tracing the card
alone, and one with the host's operations traced too.  After the
window the Worker is freed and the reference trains the watched rows
from the same weights.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import correct, inputs, reference, trace as trace_
from ..reference import synth, train as ref_train
from .common import (Job, Outcome, card_state, event_ms, free, host_line,
                     host_load, peak_bytes, phase, port_config, spread_line,
                     sync)

# what a train traffic mix may set: the rest the reference cannot follow
# yet (augmentations need the Worker's generator draws in the reference,
# a ``steps_per_dispatch`` group bypasses the watched ``train_step``)
TRAFFIC_KEYS = {"kind", "batch", "samples", "eval_samples", "augmentations",
                "warm_epochs", "checked_steps", "traced_epochs"}


def _checkable(traffic: dict) -> None:
    """Refuses a train traffic mix whose run the reference cannot check."""
    extra = sorted(set(traffic) - TRAFFIC_KEYS)
    if extra:
        raise ValueError(f"the train driver has no support for {extra}")
    if traffic["augmentations"]:
        raise ValueError("the reference trains without augmentations: "
                         f"{traffic['augmentations']} cannot be checked")


class _Watch:
    """Wraps the Worker's train step for its first ``n`` calls: the rows
    each trains on (their keypoint coordinates), its loss, the first
    step's gradient from Adam's first moment, the parameters after the
    last; then puts the step back."""

    def __init__(self, worker, n: int):
        from handpose_tpu_torch.convert import export_flax_tensors
        self.export = export_flax_tensors
        self.worker, self.n = worker, n
        self.step = worker.train_step
        self.rows, self.losses = [], []
        self.grad1 = self.params = None
        worker.train_step = self

    def __call__(self, state, raw, **kw):
        self.rows.append(raw.keypoint_xyz.detach().cpu().numpy())
        state, metrics = self.step(state, raw, **kw)
        self.losses.append(float(metrics["loss"]))
        model = self.worker.model
        if len(self.rows) == 1:
            opt = state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            # a parameter Adam never stepped got no gradient: 0
            self.grad1 = self.export(model, {
                n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - b1) for n, p in model.named_parameters()})
        if len(self.rows) == self.n:
            self.params = self.export(model, {
                n: p.detach().clone() for n, p in model.named_parameters()})
            self.worker.train_step = self.step
            self.worker = self.step = None
        return state, metrics


def _epochs(worker, first: int, seconds: float = 0.0, count: int = 0,
            times: list = None, loads: list = None):
    """Whole training epochs from ``first``: ``count`` of them, or as many
    as start before ``seconds`` have passed (each epoch's host seconds
    appended to ``times``, a :func:`host_load` after it to ``loads``).
    Returns (epochs, steps, host seconds)."""
    steps0, t0 = worker.state.step, time.perf_counter()
    epoch, at = first, t0
    while (count and epoch - first < count) or (
            not count and (epoch == first
                           or time.perf_counter() - t0 < seconds)):
        worker.run_epoch(epoch, "training")
        epoch += 1
        if times is not None:
            now = time.perf_counter()
            times.append(now - at)
            at = now
        if loads is not None:
            loads.append(host_load())
    sync(worker.device)
    return epoch - first, worker.state.step - steps0, time.perf_counter() - t0


def _epoch_load(seconds: float, a: dict, b: dict) -> str:
    if not a or not b:
        return f"{seconds * 1e3:.1f}"
    return (f"{seconds * 1e3:.1f}/{b['main'] - a['main']:.2f}/"
            f"{b['other'] - a['other']:.2f}")


def _split(worker, job: Job) -> dict:
    """Preprocessing, forward and loss, backward and Adam of one step on
    a batch of the tree, each timed alone with CUDA events (the forward
    and the backward by difference), after the window."""
    from handpose_tpu_torch.data.preprocess import model_input, \
        preprocess_fn_for
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.train import compute_losses
    cfg, model, dev = worker.cfg, worker.model, job.device
    B = job.traffic["batch"]
    raw = worker.train_ds.raw_batch(np.arange(B)).to(dev)
    pp = serving_kwargs(cfg)
    prep_fn = preprocess_fn_for(raw)

    def prep():
        with torch.no_grad():
            return prep_fn(raw, **pp)

    def fwd_loss():
        batch = prep()
        model.train()
        out = model(model_input(batch, cfg.input_channels),
                    batch["camera_intrinsic_matrix"], batch["keypoint_scale"],
                    batch["keypoint_xyz_root"],
                    batch["keypoint_xyz21_rel_normed"].reshape(B, 1, -1))
        return compute_losses(out, batch, cfg)["loss"]

    prep_ms = event_ms(prep, 5, dev)
    fwd_ms = event_ms(fwd_loss, 3, dev)
    step_ms = event_ms(lambda: worker.train_step(
        worker.state, raw, generator=worker.generator), 3, dev)
    return {"preprocess_ms": prep_ms, "forward_ms": fwd_ms - prep_ms,
            "backward_update_ms": step_ms - fwd_ms, "step_ms": step_ms}


def run(job: Job) -> Outcome:
    from handpose_tpu_torch.train import Worker
    t, c, dev = job.traffic, job.config, job.device
    _checkable(t)
    n, B = t["samples"], t["batch"]
    data, weights0 = inputs.train(c, t, job.seed, dev)
    phase("inputs made", job)
    root = os.path.join(job.workdir, "rhd")
    synth.write_rhd_tree(root, "training", {k: v[:n] for k, v in data.items()})
    synth.write_rhd_tree(root, "evaluation",
                         {k: v[n:] for k, v in data.items()})
    free(dev)
    phase("inputs and the tree written", job)
    cfg = port_config(job, dataset_name="RHD", dataset_root_dir=root,
                      save_log_dir=os.path.join(job.workdir, "logs"),
                      cache_decoded=True, steps_per_dispatch=1)
    worker = Worker(cfg, weights=weights0, device=dev)
    phase("the Worker built (its decoded caches included)", job)
    watch = _Watch(worker, t["checked_steps"])
    _epochs(worker, 0, count=t["warm_epochs"])
    phase(f"{t['warm_epochs']} warm epoch(s)", job)
    first = t["warm_epochs"]
    out = Outcome()
    if not job.trace:
        before, times, loads = card_state(dev), [], [host_load()]
        t0 = time.perf_counter()
        epochs, steps, secs = _epochs(worker, first, seconds=job.seconds,
                                      times=times, loads=loads)
        out.measured = {"train_img_per_s": steps * B / secs,
                        "setup_s": t0 - job.t_start}
        out.attempted = steps
        phase(f"the window ({spread_line('epochs', times)}; the card "
              f"before and after: {before} | {card_state(dev)}; "
              f"{host_line(loads[0], loads[-1])})", job, t0)
        phase("each epoch: ms, CPU s of the main thread, of the others: "
              + " ".join(_epoch_load(t, a, b) for t, a, b in
                         zip(times, loads, loads[1:])), job, t0)
    else:
        total0 = worker.stats.input.total
        epochs, steps, secs = _epochs(worker, first,
                                      count=t["traced_epochs"])
        wait_s = worker.stats.input.total - total0
        split = _split(worker, job)
        at = [first + epochs]

        def one_epoch() -> int:
            at[0] += 1
            return _epochs(worker, at[0] - 1, count=1)[1]

        out.trace, tr_steps = trace_.profile(one_epoch, job.workdir)
        out.host_trace, host_steps = trace_.profile(one_epoch, job.workdir,
                                                    host=True)
        out.context = {"split": split, "steps_traced": tr_steps,
                       "input_wait_ms": wait_s * 1e3 / steps,
                       "images_per_s": steps * B / secs}
        out.attempted = steps + tr_steps + host_steps
    if watch.params is None:
        raise RuntimeError(f"the warm-up ran fewer than "
                           f"{t['checked_steps']} steps")
    out.memory_peak_bytes = peak_bytes(dev)
    del worker
    free(dev)

    index = {data["xyz"][i].tobytes(): i for i in range(n)}
    rows = [np.array([index.get(r.tobytes(), -1) for r in batch])
            for batch in watch.rows]
    if any((r < 0).any() for r in rows):
        raise RuntimeError("a watched step trained on rows the tree lacks")
    t0 = time.perf_counter()
    out.numbers, out.details = check(
        c, data, weights0, rows, n // B, dev,
        {"losses": watch.losses, "grad1": watch.grad1,
         "params": watch.params})
    phase(f"the reference's {len(rows)} steps", job, t0)
    return out


def by_reference(config: dict, data: dict, weights0: dict, rows,
              steps_per_epoch: int, device, **variant) -> dict:
    """The reference's losses, first gradient and last parameters (host
    arrays) trained on ``data``'s ``rows`` (an index array a step) from
    ``weights0``; ``variant`` (``quant``, ``half_batch``) makes it the
    control or a planted fault."""
    ref = ref_train.steps(reference.module(config),
                          {k: torch.from_numpy(v).to(device)
                           for k, v in weights0.items()},
                          [inputs.on(device, data, r) for r in rows], config,
                          steps_per_epoch, **variant)
    return {"losses": ref["losses"], "grad1": inputs.host(ref["grad1"]),
            "params": inputs.host(ref["params"])}


def check(config: dict, data: dict, weights0: dict, rows,
          steps_per_epoch: int, device, prog: dict):
    """(numbers, details) of the comparison of ``prog`` (losses, grad1,
    params) with the reference on the same rows from the same weights
    (:func:`correct.train_readings`)."""
    ref = {**by_reference(config, data, weights0, rows, steps_per_epoch,
                       device), "params0": weights0}
    return correct.train_readings(prog, ref)
