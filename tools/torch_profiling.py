"""Shared helpers of ``tools/torch_serve_profile.py`` and
``tools/torch_train_profile.py``: run a function under ``torch.profiler``
on the card, sum its device kernel time by kind, and split its train
steps or serve calls by phase from the port's spans
(``handpose_tpu_torch/utils/tracing.py``)."""

import subprocess
import time
from collections import defaultdict

import torch

# kernel-name fragments -> kind, first match wins
KINDS = (("scoremap", "scoremap (K1)"), ("moments", "BN moments (K2)"),
         ("pool_bwd", "pool backward (K3)"),
         ("multi_tensor", "Adam"), ("adam", "Adam"),
         ("wgrad", "convolution"), ("dgrad", "convolution"),
         ("conv", "convolution"), ("cudnn", "convolution"),
         ("sm90_xmma", "convolution"), ("implicit", "convolution"),
         ("nhwc", "convolution"),
         ("gemm", "matmul"), ("cutlass", "matmul"), ("Memcpy", "copy"),
         ("Memset", "copy"), ("gather", "gather"), ("scatter", "gather"),
         ("reduce", "reduction"),
         ("max_pool", "max pool"), ("elementwise", "elementwise"),
         ("vectorized", "elementwise"), ("unrolled", "elementwise"))


def kind_of(name: str) -> str:
    for frag, kind in KINDS:
        if frag.lower() in name.lower():
            return kind
    return "other"


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def profiled(fn, iters: int, unit: str = None) -> dict:
    """``fn`` run ``iters`` times under the profiler after the caller's
    warm-up: per call, the wall ms, the device kernel ms (``kernel_ms``),
    the kernels launched, the kernel ms by kind, the kernels as (ms,
    launches, name), longest first, and with ``unit`` (``hp.train.step``
    or ``hp.serve.call``) the recorder's split of those units by phase
    (``phases``: each span's device and host ms and each count, per
    unit)."""
    from torch.profiler import ProfilerActivity, profile

    from handpose_tpu_torch.utils.tracing import RECORDER
    torch.cuda.synchronize()
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_kind = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
        if evt.device_type.name != "CUDA" or dev_us <= 0:
            continue
        if getattr(evt, "is_user_annotation", False) or \
                evt.key == "DistributedDataParallel.forward":
            # a range the profiler also reports on the device (DDP's
            # forward, around the kernels it holds), not a kernel
            continue
        kernels.append((dev_us / iters / 1e3, evt.count / iters, evt.key))
        by_kind[kind_of(evt.key)] += dev_us / iters / 1e3
    kernels.sort(reverse=True)
    kernel_ms = sum(ms for ms, _, _ in kernels)
    phases = RECORDER.phases(unit) if unit else {}
    RECORDER.clear()
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "launches": sum(n for _, n, _ in kernels),
            "by_kind_ms": dict(by_kind), "kernels": kernels,
            "phases": phases}


def with_sampler_kind(whole: dict, sampler: dict) -> dict:
    """``whole``'s kernel ms by kind with one ``sampler`` pass (profiled
    alone on the same inputs) taken out of each kind and reported as the
    kind "sampler (DDIM pass)"."""
    rest = {k: max(ms - sampler["by_kind_ms"].get(k, 0.0), 0.0)
            for k, ms in whole["by_kind_ms"].items()}
    return {"sampler (DDIM pass)": sampler["kernel_ms"], **rest}


def report(title: str, card: str, run: dict, by_kind: dict, top: int):
    """Print the phases, kinds, shares and top kernels of a
    :func:`profiled` run."""
    print(f"card: {card}")
    print(f"{title}: {run['wall_ms']:.3f} ms wall, {run['kernel_ms']:.3f} "
          f"ms summed kernel time, {run['launches']:.0f} kernels")
    if run["phases"]:
        print("phases (device ms between each span's events, host ms):")
        for name, v in run["phases"].items():
            if name.startswith("count "):
                print(f"  {name:22s} {v:9.2f}")
            else:
                dev = "-" if v["device_ms"] is None else \
                    f"{v['device_ms']:.3f}"
                print(f"  {name:22s} {dev:>9s} {v['host_ms']:9.3f}")
    total = sum(by_kind.values())
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:20s} {ms:9.3f} ms  {ms / total:6.1%}")
    print("top kernels (ms per call, launches per call):")
    for ms, n, name in run["kernels"][:top]:
        print(f"  {ms:8.3f} {n:7.0f}  {name[:100]}")
