#!/usr/bin/env python3
"""Where the time of the port's serving step goes, on one card.

    python tools/torch_serve_profile.py [--model M] [--batch 256] [--iters 5]

Runs ``handpose_tpu_torch.infer.serving.serve`` (``--model``, default
Hand3DPosePriorNetwork, with the model's default input channels; full
width, bf16, seeded weights) on a device-resident synthetic RHD batch
under ``torch.profiler`` and prints the card's name and power limit, the
device kernel time grouped by kind (convolution, elementwise, ...), the
top kernels by device time, and the device's busy share of the wall
time.  For DiffusionHandPose one sampler pass on the batch's features is
also profiled alone and reported as its own kind, taken out of the
others, with its busy share and kernels per denoise step.  The last line
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
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")

    from handpose_tpu_torch import Config
    from handpose_tpu_torch.config import default_input_channels
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer import load_serving_model, serve
    from handpose_tpu_torch.infer.evaluator import serving_kwargs

    card = card_line()
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
    run = profiled(lambda: serve(model, raw, cfg, dev), args.iters)
    by_kind = run["by_kind_ms"]
    out = {"card": card, "model": args.model, "batch": args.batch,
           "step_ms": run["wall_ms"], "device_kernel_ms": run["kernel_ms"],
           "device_busy_share": run["kernel_ms"] / run["wall_ms"],
           "kernels_per_step": run["launches"]}
    sampler = None
    if hasattr(model, "diff_model"):
        with torch.inference_mode():
            sample = preprocess_batch(raw, **serving_kwargs(cfg))
            feat = model.features(model_input(sample, cfg.input_channels))
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            sampler = profiled(lambda: model.diff_model.sample(feat, gen), 1)
        by_kind = with_sampler_kind(run, sampler)
        steps = cfg.num_sampling_timesteps
        out.update({
            "sampler_pass_ms": sampler["wall_ms"],
            "sampler_kernel_ms": sampler["kernel_ms"],
            "sampler_busy_share": sampler["kernel_ms"] / sampler["wall_ms"],
            "sampler_kernels_per_denoise_step": sampler["launches"] / steps,
            "sampler_share_of_step_kernel_ms":
                sampler["kernel_ms"] / run["kernel_ms"],
            "sampler_by_kind_ms": sampler["by_kind_ms"]})
    report(f"{args.model} serve b{args.batch} (per call)", card, run,
           by_kind, 15)
    if sampler is not None:
        print(f"sampler pass alone: {sampler['wall_ms']:.3f} ms wall, "
              f"{sampler['kernel_ms']:.3f} ms kernels "
              f"({out['sampler_busy_share']:.1%} busy), "
              f"{out['sampler_kernels_per_denoise_step']:.0f} kernels a "
              "denoise step")
    out["by_kind_ms"] = by_kind
    print(json.dumps(out))


if __name__ == "__main__":
    main()
