#!/usr/bin/env python3
"""How DiffusionHandPose's sampler rounds on the card and on the host.

    python tools/torch_sampler_rounding.py [--seeds 7 0 1 2]

The model of ``chip_smoke.py``'s card-vs-host check (seed 0, float32,
crop 64, the full T = 400 / S = 200 DDIM ladder, b4, conditioned on its
trunk's features of a synthetic RHD batch), with TF32 off:

- per layer kind of ``Unet1D``: each layer fed its float64 input cast
  to float32, its output's distance from float64 (share of range) on
  each device, largest and mean over the layers of three calls;
- per injected x_T (``--seeds``): the sample in float32 and float64 on
  both devices, and on the card in float32 with cuDNN deterministic and
  with cuDNN off; the distances between them;
- the sampler's pass time at full width on random conditions, hoisted
  and not, at b4, b8, b32 and b256 (two calls each after a warm one,
  CUDA events).

Prints the card's name and power limit, one JSON line per part, and the
whole as one JSON object last.  Needs a card; imports nothing of JAX.
"""

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_profiling import card_line  # noqa: E402


def rel(ref, out):
    ref, out = ref.double().cpu(), out.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-12))


def per_layer(host, card, cond, dev):
    """Each layer's float32 rounding on either device, by kind."""
    from handpose_tpu_torch.nn import diffusion as D
    kinds = (D.ConvNd, D.GroupNorm, D.Linear, D.RMSNorm, D.LinearAttention,
             D.Attention)
    host64 = copy.deepcopy(host).double()
    seen = {}
    for name, m in host64.named_modules():
        if isinstance(m, kinds):
            m.register_forward_hook(
                lambda mod, a, o, name=name: seen.update({name: (a[0], o)}))
    hmods, cmods = dict(host.named_modules()), dict(card.named_modules())
    x = torch.randn(4, 63, 1, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    errs, whole = {}, {}
    for t in (399, 200, 5):
        seen.clear()
        tt = torch.full((4,), t)
        with torch.no_grad():
            want = host64(x, tt, cond.double())
            whole[f"unet_t{t}"] = {
                "host": rel(want, host(x.float(), tt, cond)),
                "card": rel(want, card(x.float().to(dev), tt.to(dev),
                                       cond.to(dev)))}
            for name, (a, o) in seen.items():
                e = errs.setdefault(type(hmods[name]).__name__,
                                    {"host": [], "card": []})
                e["host"].append(rel(o, hmods[name](a.float())))
                e["card"].append(rel(o, cmods[name](a.float().to(dev))))
    out = {k: {"layers": len(v["host"]),
               **{f"{d}_{f.__name__}": float(f(v[d]))
                  for d in ("host", "card") for f in (np.max, np.mean)}}
           for k, v in errs.items()}
    return {**out, **whole}


def samples(host, card, cond, dev, seed):
    """One x_T: the sample on both devices in both dtypes, and on the
    card in float32 under two cuDNN settings; their distances."""
    x_T = torch.randn(4, 1, 63, generator=torch.Generator().manual_seed(seed))
    host64, card64 = copy.deepcopy(host).double(), copy.deepcopy(card).double()

    def run(m, d, dt):
        with torch.no_grad():
            return m.sample(cond.to(d, dt), init_noise=x_T.to(d, dt)).cpu()

    h32, h64 = run(host, "cpu", torch.float32), run(host64, "cpu",
                                                    torch.float64)
    c32, c64 = run(card, dev, torch.float32), run(card64, dev, torch.float64)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        det = run(card, dev, torch.float32)
    with torch.backends.cudnn.flags(enabled=False):
        native = run(card, dev, torch.float32)
    return {"seed": seed, "card64_vs_host64": rel(h64, c64),
            "host32_vs_host64": rel(h64, h32),
            "card32_vs_card64": rel(c64, c32),
            "card32_vs_host32": rel(h32, c32),
            "card32_deterministic_vs_card32": rel(c32, det),
            "card32_no_cudnn_vs_host64": rel(h64, native),
            "card32_no_cudnn_vs_host32": rel(h32, native),
            "finite": bool(torch.isfinite(h64).all())}


def pass_times(card, dev):
    """The full-width pass, hoisted and not, by batch size (ms)."""
    model = copy.deepcopy(card)
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for B in (4, 8, 32, 256):
        cond = torch.randn(B, 256, generator=g, device=dev)
        x_T = torch.randn(B, 1, 63, generator=g, device=dev)
        for hoist in (True, False):
            model.sampler_hoist = hoist
            model.sample(cond, init_noise=x_T)                 # warm
            ms = []
            for _ in range(2):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                model.sample(cond, init_noise=x_T)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            out[f"b{B}_{'hoisted' if hoist else 'unhoisted'}_ms"] = ms
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, nargs="+", default=[7, 0, 1, 2])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sampler_rounding: no CUDA device")
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer import load_serving_model
    from handpose_tpu_torch.infer.evaluator import serving_kwargs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(8)
    dev = torch.device("cuda")
    result = {"card": card_line()}
    print(result["card"], flush=True)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=0)
        raw = RHDDataset(root, "evaluation").raw_batch(range(4)).to("cpu")
        cfg = Config(model_name="DiffusionHandPose", input_channels=3,
                     compute_dtype="float32", input_img_shape=(64, 64),
                     dataset_root_dir=root)
        model = load_serving_model(cfg, device="cpu")
        with torch.no_grad():
            cond = model.features(model_input(
                preprocess_batch(raw, **serving_kwargs(cfg)),
                cfg.input_channels)).float()
    host = model.diff_model
    card = copy.deepcopy(host).to(dev)
    result["per_layer"] = per_layer(host.unet, card.unet, cond, dev)
    print(json.dumps({"per_layer": result["per_layer"]}), flush=True)
    result["samples"] = []
    for seed in args.seeds:
        result["samples"].append(samples(host, card, cond, dev, seed))
        print(json.dumps(result["samples"][-1]), flush=True)
    result["pass_ms"] = pass_times(card, dev)
    print(json.dumps({"pass_ms": result["pass_ms"]}), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
