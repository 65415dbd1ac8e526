#!/usr/bin/env python3
"""Where the time of the port's serving step goes, on one card.

    python tools/torch_serve_profile.py [--model M] [--batch 256] [--iters 5]

Runs ``handpose_tpu_torch.infer.serve`` (``--model``, default
Hand3DPosePriorNetwork, with the model's default input channels; full
width, bf16, seeded weights) on a device-resident synthetic RHD batch
under ``torch.profiler`` and prints the card's name and power limit, the
device kernel time grouped by kind (convolution, elementwise, ...), the
top kernels by device time, and the device's busy share of the wall
time.  The last line is one JSON object with those numbers.  Needs a
card; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# kernel-name fragments -> kind, first match wins
KINDS = (("scoremap", "scoremap (K1)"),
         ("conv", "convolution"), ("cudnn", "convolution"),
         ("sm90_xmma", "convolution"), ("implicit", "convolution"),
         ("gemm", "matmul"), ("cutlass", "matmul"), ("Memcpy", "copy"),
         ("Memset", "copy"), ("gather", "gather"), ("reduce", "reduction"),
         ("max_pool", "max pool"), ("elementwise", "elementwise"),
         ("vectorized", "elementwise"), ("unrolled", "elementwise"))


def kind_of(name: str) -> str:
    for frag, kind in KINDS:
        if frag.lower() in name.lower():
            return kind
    return "other"


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="Hand3DPosePriorNetwork")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    from torch.profiler import ProfilerActivity, profile

    from handpose_tpu_torch import Config
    from handpose_tpu_torch.config import default_input_channels
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer import load_serving_model, serve

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = Config(model_name=args.model,
                 input_channels=default_input_channels(args.model))
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=args.batch, seed=0)
        raw = RHDDataset(root, "evaluation", cache_decoded=True).raw_batch(
            range(args.batch)).to(dev)
    model = load_serving_model(cfg, device=dev)
    for _ in range(2):
        serve(model, raw, cfg, dev)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            serve(model, raw, cfg, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_kind = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
        if evt.device_type.name != "CUDA" or dev_us <= 0:
            continue
        kernels.append((dev_us / args.iters / 1e3, evt.count // args.iters,
                        evt.key))
        by_kind[kind_of(evt.key)] += dev_us / args.iters / 1e3
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    step_ms = wall_ms / args.iters
    busy_share = busy_ms / step_ms
    print(f"card: {card}")
    print(f"{args.model} serve b{args.batch}: {step_ms:.3f} ms wall per "
          "step, "
          f"{busy_ms:.3f} ms device kernel time")
    if busy_share > 1:
        print(f"note: kernel time exceeds wall time ({busy_share:.3f}): "
              "kernels overlapped on several streams, or the profiler "
              "counted some twice")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:16s} {ms:9.3f} ms  {ms / busy_ms:6.1%}")
    print("top kernels (ms per step, launches per step):")
    for ms, n, name in kernels[:15]:
        print(f"  {ms:8.3f} {n:5d}  {name[:100]}")
    print(json.dumps({
        "card": card, "model": args.model, "batch": args.batch,
        "step_ms": step_ms, "device_kernel_ms": busy_ms,
        "device_busy_share": busy_share,
        "by_kind_ms": dict(by_kind)}))


if __name__ == "__main__":
    main()
