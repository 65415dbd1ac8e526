#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one card.

    python tools/torch_train_profile.py [--model M] [--batch 256] [--iters 3]
                                        [--ddp]

Runs the fused train step of ``handpose_tpu_torch`` (``--model``, default
Hand3DPosePriorNetwork, with the model's default input channels; full
width, bf16 compute, bn_variance 'fast', Adam with the cosine LR, seeded
weights) on a device-resident synthetic RHD batch under
``torch.profiler`` and prints the card's name and power limit, the device
kernel time per step grouped by kind (convolution, BN moments K2, pool
backward K3, elementwise, ...), the top kernels by device time, and the
step's split by phase from the port's spans (preprocess, forward,
backward, update: device ms between each span's events and host ms).
For DiffusionHandPose, whose forward runs its 200-step DDIM sampler, one
sampler pass on the step's features is also profiled alone: its kernels
are reported as their own kind, taken out of the others, with its
kernels per denoise step.  With ``--ddp`` the same step also runs
replicated (``parallel.replicate``) inside a process group of one rank
over NCCL, as the Worker runs it under a group, and is profiled after
the plain one from the same seeded weights: the two reports side by
side, and the collectives' calls and host time per step.  The last line
is one JSON object with those numbers.  Needs a card; imports nothing of
JAX.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_profiling import (card_line, profiled, report,  # noqa: E402
                             with_sampler_kind)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="Hand3DPosePriorNetwork")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--ddp", action="store_true",
                   help="also profile the step replicated in a one-rank "
                        "NCCL group")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")

    from handpose_tpu_torch import Config
    from handpose_tpu_torch.config import default_input_channels
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)

    card = card_line()
    dev = torch.device("cuda")
    cfg = Config(model_name=args.model,
                 input_channels=default_input_channels(args.model),
                 batch_size=args.batch)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=args.batch, seed=0)
        raw = RHDDataset(root, "evaluation", cache_decoded=True).raw_batch(
            range(args.batch)).to(dev)
    model = build_model(cfg).to(dev)
    state = create_train_state(model, cfg)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 serving_kwargs(cfg))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    losses = {}

    def one_step():
        losses.update(step(state, raw, generator=gen)[1])

    for _ in range(2):
        one_step()
    run = profiled(one_step, args.iters, "hp.train.step")
    by_kind = run["by_kind_ms"]
    out = {"card": card, "model": args.model, "batch": args.batch,
           "step_ms": run["wall_ms"], "device_kernel_ms": run["kernel_ms"],
           "kernels_per_step": run["launches"], "phases": run["phases"]}
    sampler = None
    if hasattr(model, "diff_model"):
        with torch.no_grad():
            sample = preprocess_batch(raw, **serving_kwargs(cfg))
            feat = model.features(model_input(sample, cfg.input_channels))
            sampler = profiled(lambda: model.diff_model.sample(feat, gen), 1)
        by_kind = with_sampler_kind(run, sampler)
        steps = cfg.num_sampling_timesteps
        out.update({
            "sampler_pass_ms": sampler["wall_ms"],
            "sampler_kernel_ms": sampler["kernel_ms"],
            "sampler_kernels_per_denoise_step": sampler["launches"] / steps,
            "sampler_share_of_step_kernel_ms":
                sampler["kernel_ms"] / run["kernel_ms"],
            "sampler_by_kind_ms": sampler["by_kind_ms"]})
    report(f"{args.model} train step b{args.batch} (per step, loss "
           f"{float(losses['loss']):.5f})", card, run, by_kind, 20)
    if sampler is not None:
        print(f"sampler pass alone: {sampler['wall_ms']:.3f} ms wall, "
              f"{sampler['kernel_ms']:.3f} ms kernels, "
              f"{out['sampler_kernels_per_denoise_step']:.0f} kernels a "
              "denoise step")
    out["by_kind_ms"] = by_kind
    if args.ddp:
        out["ddp"] = ddp_profile(cfg, raw, dev, card, args.iters)
    print(json.dumps(out))


def ddp_profile(cfg, raw, dev, card, iters: int) -> dict:
    """The fused step of the seeded model replicated in a one-rank NCCL
    group: its profile, and the host time of its collectives' calls
    (``c10d``/``nccl`` events on the host) per step."""
    import socket
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.parallel import initialize_distributed, replicate
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    model = build_model(cfg).to(dev)
    state = create_train_state(model, cfg)
    step = make_fused_train_step(replicate(model), cfg, preprocess_batch,
                                 serving_kwargs(cfg))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)

    def one_step():
        step(state, raw, generator=gen)

    for _ in range(2):
        one_step()
    run = profiled(one_step, iters, "hp.train.step")
    report(f"{cfg.model_name} train step b{cfg.batch_size}, replicated in "
           "a one-rank NCCL group (per step)", card, run, run["by_kind_ms"],
           20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            one_step()
        torch.cuda.synchronize()
    coll = [(e.cpu_time_total / iters / 1e3, e.count / iters, e.key)
            for e in prof.key_averages()
            if any(k in e.key.lower() for k in ("c10d", "nccl", "allreduce",
                                                 "all_reduce"))]
    coll.sort(reverse=True)
    print("collectives on the host (ms per step, calls per step):")
    for ms, n, name in coll[:12]:
        print(f"  {ms:8.3f} {n:7.1f}  {name[:100]}")
    dist.destroy_process_group()
    return {"step_ms": run["wall_ms"], "device_kernel_ms": run["kernel_ms"],
            "kernels_per_step": run["launches"], "phases": run["phases"],
            "by_kind_ms": run["by_kind_ms"],
            "collectives_host": [{"name": n, "calls": c, "host_ms": ms}
                                 for ms, c, n in coll[:12]]}


if __name__ == "__main__":
    main()
