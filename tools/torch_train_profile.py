#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one card.

    python tools/torch_train_profile.py [--batch 256] [--iters 3]

Runs the fused train step of ``handpose_tpu_torch`` (Hand3DPosePriorNetwork,
full width, bf16 compute, bn_variance 'fast', Adam with the cosine LR,
seeded weights) on a device-resident synthetic RHD batch under
``torch.profiler`` and prints the card's name and power limit, the device
kernel time per step grouped by kind (convolution, BN moments K2, pool
backward K3, elementwise, ...), the top kernels by device time, and the
device's busy share of the wall time.  The last line is one JSON object
with those numbers.  Needs a card; imports nothing of JAX.
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
KINDS = (("scoremap", "scoremap (K1)"), ("moments", "BN moments (K2)"),
         ("pool_bwd", "pool backward (K3)"),
         ("multi_tensor", "Adam"), ("adam", "Adam"),
         ("wgrad", "convolution"), ("dgrad", "convolution"),
         ("conv", "convolution"), ("cudnn", "convolution"),
         ("sm90_xmma", "convolution"), ("implicit", "convolution"),
         ("nhwc", "convolution"),
         ("gemm", "matmul"), ("cutlass", "matmul"), ("Memcpy", "copy"),
         ("Memset", "copy"), ("gather", "gather"), ("scatter", "gather"),
         ("reduce", "reduction"), ("max_pool", "max pool forward"),
         ("elementwise", "elementwise"), ("vectorized", "elementwise"),
         ("unrolled", "elementwise"))


def kind_of(name: str) -> str:
    for frag, kind in KINDS:
        if frag.lower() in name.lower():
            return kind
    return "other"


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    from torch.profiler import ProfilerActivity, profile

    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 batch_size=args.batch)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=args.batch, seed=0)
        raw = RHDDataset(root, "evaluation").raw_batch(
            range(args.batch)).to(dev)
    model = build_model(cfg).to(dev)
    state = create_train_state(model, cfg)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 serving_kwargs(cfg))
    for _ in range(2):
        state, _ = step(state, raw)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, losses = step(state, raw)
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
    print(f"train step b{args.batch}: {step_ms:.3f} ms wall per step, "
          f"{busy_ms:.3f} ms device kernel time, loss "
          f"{float(losses['loss']):.5f}")
    if busy_share > 1:
        print(f"note: kernel time exceeds wall time ({busy_share:.3f}): "
              "kernels overlapped on several streams, or the profiler "
              "counted some twice")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:20s} {ms:9.3f} ms  {ms / busy_ms:6.1%}")
    print("top kernels (ms per step, launches per step):")
    for ms, n, name in kernels[:20]:
        print(f"  {ms:8.3f} {n:5d}  {name[:100]}")
    print(json.dumps({
        "card": card, "batch": args.batch, "step_ms": step_ms,
        "device_kernel_ms": busy_ms, "device_busy_share": busy_share,
        "by_kind_ms": dict(by_kind)}))


if __name__ == "__main__":
    main()
