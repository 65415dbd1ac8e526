"""What the drivers share: the job they are given, the outcome they
return, CUDA-event timing and the port's configuration from a
benchmark configuration file."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


@dataclass
class Job:
    """One run of one cell."""

    cell: str
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str            # scratch space, removed after the run
    t_start: float          # the host clock at process start


@dataclass
class Outcome:
    measured: Dict[str, float] = field(default_factory=dict)
    context: dict = field(default_factory=dict)   # for the metric readers
    numbers: Dict[str, float] = field(default_factory=dict)
    details: dict = field(default_factory=dict)    # for the calibration
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: object = None        # the card's activity alone
    host_trace: object = None   # the same work with the host's operations


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn: Callable, iters: int, device: torch.device) -> float:
    """Mean time of ``fn`` over ``iters`` calls after one warm call, from
    CUDA events around the calls (the host clock off the card)."""
    fn()
    sync(device)
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def port_config(job: Job, **kw):
    """The port's ``Config`` for the job's configuration and traffic."""
    from handpose_tpu_torch import Config
    c, t = job.config, job.traffic
    return Config(model_name=c["model_name"],
                  input_channels=c["input_channels"],
                  input_img_shape=(c["crop"], c["crop"]), sigma=c["sigma"],
                  resnet_stem=c["resnet_stem"],
                  resnet_out_feature_dim=c["resnet_out_feature_dim"],
                  bn_variance=c["bn_variance"],
                  compute_dtype=c["compute_dtype"],
                  param_dtype=c["param_dtype"], lr=c["lr"],
                  lr_min=c["lr_min"], max_epoch=c["max_epoch"],
                  batch_size=t["batch"], infer_batch_size=t["batch"],
                  seed=job.seed, **kw)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank: a value that was measured."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, -(-int(q * 1000) * len(s) // 1000) - 1))]


def phase(what: str, job: Job, since: float = None) -> None:
    """A line on standard error: the seconds since ``since`` (else since
    the process started) when ``what`` was done."""
    t0 = job.t_start if since is None else since
    print(f"port_bench: {what}: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)


def card_state(device: torch.device) -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi), or
    '' off the card."""
    if device.type != "cuda":
        return ""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def host_load():
    """This process's CPU seconds in its main thread, which issues the
    card's work, and in its other threads (``/proc/self/task``), and the
    host clock; empty where ``/proc`` cannot be read.  (The card's
    machine gives no readings of the host's other load.)"""
    import os
    try:
        tick = os.sysconf("SC_CLK_TCK")
        main = other = 0.0
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    stat = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            secs = (int(stat[11]) + int(stat[12])) / tick
            if int(tid) == os.getpid():
                main += secs
            else:
                other += secs
    except (OSError, ValueError, IndexError):
        return {}
    return {"main": main, "other": other, "at": time.perf_counter()}


def host_line(before: dict, after: dict) -> str:
    """The CPU time this process took between two :func:`host_load`
    readings."""
    if not before or not after:
        return "the host: not read"
    d = {k: after[k] - before[k] for k in before}
    return (f"over {d['at']:.2f} s this process's main thread took "
            f"{d['main']:.2f} s of CPU, its other threads {d['other']:.2f} s")


def spread_line(name: str, values: List[float]) -> str:
    """min, quartiles, max and the halves' medians of ``values`` (ms)."""
    if not values:
        return f"{name}: none"
    s = sorted(values)
    q = [s[int(f * (len(s) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
    h = len(values) // 2
    halves = [sorted(part)[len(part) // 2] for part in (values[:h] or values,
                                                        values[h:])]
    return (f"{name} ms over {len(values)}: min/q1/median/q3/max "
            + "/".join(f"{v * 1e3:.2f}" for v in q)
            + "; halves' medians "
            + "/".join(f"{v * 1e3:.2f}" for v in halves))
