#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (handpose_tpu_torch) on one card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the serving path from handpose_tpu_torch/csrc;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the serving shapes and at edge cases, then timed with CUDA events
   beside the least time the card could take (its bound);
4. serving phase: a 520-sample synthetic RHD tree in the decoded-cache
   form; the Evaluator at batch 256 (two full batches and one of 8) and
   ``serve`` on one batch, full width (crop 256, 21 input channels, two
   ResNet-18 trunks), bf16 compute, seeded weights.  Checks finite
   outputs, one scoremap launch per batch, agreement with the same
   pipeline with the plain render substituted, agreement of the card with
   the host path (which the CPU tests hold to the JAX package) on a small
   batch, and the ground-truth reprojection of the preprocessing; then
   times the layers;
5. prints the ``kernels`` line, the card line and, last, the result line.

Any failed check raises, so the script exits non-zero; without a card, or
without the package beside it, it exits non-zero before printing results.
Imports nothing of JAX.
"""

import json
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores
N_SAMPLES, BATCH = 520, 256
# kernel vs plain render through the bf16 trunks: the two renders differ
# by <= 1e-6, which bf16 turns into single-ulp flips of the trunk input
BF16_RTOL = 1e-2
F32_RTOL = 1e-4                  # as tests/test_torch_model_f32.py


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")
    print(f"[ok] {what}", flush=True)


def rel_err(ref, out):
    ref, out = ref.double().cpu(), out.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-12))


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls after one warm
    call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel phase


def scoremap_inputs(B, K, H, W, seed, dev):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-20, max(H, W) + 20, (B, K, 2)).astype(np.float32)
    edges = [(0, 5), (H - 1, 5), (1, W - 1), (-0.5, 3), (-7, -2),
             (H - 1.5, W - 1.5)][:K]
    coords[0, :len(edges)] = edges
    vis = rng.uniform(size=(B, K)) > 0.25
    return (torch.from_numpy(coords).to(dev), torch.from_numpy(vis).to(dev))


def scoremap_phase(dev, raw_host):
    """K1 against its plain version: the coords and visibility that the
    preprocessing of the first serving batch hands it, then edge cases;
    then times at the serving shape."""
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.ops import heatmap
    from handpose_tpu_torch.ops.scoremap_cuda import \
        render_gaussian_maps_cuda as kernel

    cfg = Config()
    crop, sigma = cfg.crop_size, cfg.sigma
    with torch.inference_mode():
        s = preprocess_batch(raw_host.to(dev), crop_size=crop, sigma=sigma,
                             switch_joint_order=False)
        serving_coords = torch.stack([s["keypoint_uv21"][..., 1],
                                      s["keypoint_uv21"][..., 0]],
                                     -1).contiguous()
        serving_vis = s["keypoint_vis21"].contiguous()
        del s
    plain = heatmap.render_gaussian_maps
    cases = [("serving", serving_coords, serving_vis, (crop, crop))]
    for B, K, H, W in ((BATCH, 21, 256, 256), (2, 21, 320, 320),
                       (2, 21, 320, 240), (2, 5, 37, 53), (1, 3, 1, 1)):
        c, v = scoremap_inputs(B, K, H, W, seed=H * W, dev=dev)
        cases.append((f"{B}x{K}x{H}x{W}", c, v, (H, W)))
    max_err = 0.0
    for name, c, v, size in cases:
        out = kernel(c, size, sigma, v)
        torch.cuda.synchronize()
        ref = plain(c, size, sigma, v)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(err <= 1e-6, f"scoremap kernel == plain, {name}: "
              f"max |diff| {err:.3g} <= 1e-6")
        del out, ref

    c, v = serving_coords, serving_vis
    B, K = c.shape[:2]
    ms = cuda_ms(lambda: kernel(c, (crop, crop), sigma, v), 20)
    plain_ms = cuda_ms(lambda: plain(c, (crop, crop), sigma, v), 10)
    # bound: each output written once, each input read once; exp and 6
    # flops for each element of a map whose gate is on
    n_bytes = B * K * crop * crop * 4 + c.numel() * 4 + v.numel()
    ci = c.to(torch.int32).to(torch.float32)
    on = (v.reshape(B, K) & (ci[..., 0] > 0) & (ci[..., 0] < crop - 1)
          & (ci[..., 1] > 0) & (ci[..., 1] < crop - 1))
    n_ops = int(on.sum()) * crop * crop * 7
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    print(f"scoremap b{B}x{K}x{crop}x{crop}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({n_bytes} B written+read, {n_ops} flop)", flush=True)
    return {"name": "scoremap", "route": "cuda",
            "source": "handpose_tpu_torch/csrc/scoremap.cu",
            "replaces": "handpose_tpu/ops/pallas_kernels.py:39",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# serving phase


def serving_phase(dev, root, raw_host):
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer import (Evaluator, load_serving_model,
                                          serve)
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.ops import heatmap, scoremap_cuda
    from handpose_tpu_torch.ops.projection import batch_project_xyz_to_uv

    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_name="RHD", dataset_root_dir=root,
                 infer_batch_size=BATCH)
    check(cfg.crop_size == 256 and cfg.compute_dtype == "bfloat16",
          "full width: crop 256, bf16 compute, f32 params")
    ds = RHDDataset(root, "evaluation")
    raw_dev = raw_host.to(dev)
    kernel = scoremap_cuda.KERNEL

    ev = Evaluator(cfg, device=dev)
    server = load_serving_model(cfg, device=dev)
    ev.evaluate(max_batches=1)                       # warm: cuDNN, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, with the launch count read around it ----
    kernel.launches = 0
    t0 = time.perf_counter()
    mpjpe = ev.evaluate()
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    eval_launches = kernel.launches
    xyz, uv = serve(server, raw_dev, cfg, device=dev)
    torch.cuda.synchronize()
    launches = kernel.launches
    n_batches = -(-N_SAMPLES // BATCH)
    check(eval_launches == n_batches,
          f"scoremap launched once per Evaluator batch ({eval_launches} "
          f"for {n_batches} batches of {N_SAMPLES} samples at {BATCH})")
    check(launches == n_batches + 1, "serve launched it once more")
    peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(mpjpe) and mpjpe > 0,
          f"whole-split MPJPE finite: {mpjpe:.4f} mm")
    check(tuple(xyz.shape) == (BATCH, 21, 3) and tuple(uv.shape) ==
          (BATCH, 21, 2), f"serve shapes ({BATCH}, 21, 3), ({BATCH}, 21, 2)")
    check(bool(torch.isfinite(xyz).all() and torch.isfinite(uv).all()),
          "serve outputs finite")

    # ---- the same pipeline with the plain render substituted ----
    with mock.patch.object(pp_mod, "render_gaussian_maps_cuda",
                           heatmap.render_gaussian_maps):
        xyz_p, uv_p = serve(server, raw_dev, cfg, device=dev)
    check(kernel.launches == launches, "the plain substitute launched "
          "no kernel")
    e_xyz, e_uv = rel_err(xyz_p, xyz), rel_err(uv_p, uv)
    check(e_xyz <= BF16_RTOL and e_uv <= BF16_RTOL,
          f"serve with kernel vs plain render (bf16): xyz {e_xyz:.3g}, "
          f"uv {e_uv:.3g} of range <= {BF16_RTOL}")

    # ---- card against the host path, float32, TF32 off ----
    cfg32 = cfg.replace(compute_dtype="float32")
    small = ds.raw_batch(range(4))
    host = serve(load_serving_model(cfg32, device="cpu"), small, cfg32,
                 device="cpu")
    card = serve(load_serving_model(cfg32, device=dev), small, cfg32,
                 device=dev)
    errs = [rel_err(a, b) for a, b in zip(host, card)]
    check(max(errs) <= F32_RTOL,
          f"card vs host path, f32, b4: xyz {errs[0]:.3g}, uv {errs[1]:.3g}"
          f" of range <= {F32_RTOL}")

    # ---- ground truth through the card's preprocessing reprojects ----
    with torch.inference_mode():
        s = preprocess_batch(raw_dev, **serving_kwargs(cfg))
        uv_gt = batch_project_xyz_to_uv(s["keypoint_xyz21"],
                                        s["camera_intrinsic_matrix"])
        vis = s["keypoint_vis21"][..., 0]
        dev_px = float((uv_gt - s["keypoint_uv21"]).abs()[vis].max())
        del s
    check(dev_px <= 0.5, f"GT reprojection on the card: max {dev_px:.3g} px "
          "over visible joints <= 0.5")

    # ---- layer times, device-resident b256 ----
    with torch.inference_mode():
        sample = preprocess_batch(raw_dev, **serving_kwargs(cfg))
        inp = model_input(sample, 21)
        x = inp.permute(0, 3, 1, 2).to(dtype=torch.bfloat16,
                                       memory_format=torch.channels_last)
        K, sc, rt = (sample["camera_intrinsic_matrix"],
                     sample["keypoint_scale"], sample["keypoint_xyz_root"])
        layers = {
            "serve_ms": cuda_ms(lambda: serve(server, raw_dev, cfg, dev), 5),
            "preprocess_ms": cuda_ms(
                lambda: preprocess_batch(raw_dev, **serving_kwargs(cfg)), 5),
            "forward_ms": cuda_ms(lambda: server(inp, K, sc, rt), 5),
            "trunk_poseprior_ms": cuda_ms(
                lambda: server.PosePrior_net.backbone(x), 5),
            "trunk_viewpoint_ms": cuda_ms(
                lambda: server.ViewPoint_net.backbone(x), 5),
        }
        del sample, inp, x
    layers["heads_and_cast_ms"] = (layers["forward_ms"]
                                   - layers["trunk_poseprior_ms"]
                                   - layers["trunk_viewpoint_ms"])
    # a pass is ~0.3 s on the host's clock, so one pass is a smoke reading:
    # the main-path pass and four more give the spread
    eval_s = [t_eval]
    for _ in range(4):
        t0 = time.perf_counter()
        ev.evaluate()
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    serving = {
        "mpjpe_mm": mpjpe,
        "evaluator_img_per_s_passes": [N_SAMPLES / t for t in eval_s],
        "serve_img_per_s_b256_device_resident":
            BATCH / layers["serve_ms"] * 1e3,
        "max_memory_allocated_bytes": peak,
        **layers,
    }
    return serving, launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.ops import cuda_build, scoremap_cuda

    card = card_line()
    print(f"card: {card}", flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    log = cuda_build.build(scoremap_cuda.SOURCE)
    print(f"built {scoremap_cuda.SOURCE}.cu in "
          f"{time.perf_counter() - t0:.1f} s" if log is not None else
          f"{scoremap_cuda.SOURCE}.cu already built", flush=True)
    if log:
        print(f"--- nvcc {scoremap_cuda.SOURCE}.cu ---\n{log.strip()}",
              flush=True)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_synthetic_rhd(root, "evaluation", n=N_SAMPLES, seed=0)
        print(f"wrote the {N_SAMPLES}-sample tree in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        raw_host = RHDDataset(root, "evaluation").raw_batch(range(BATCH))
        k1 = scoremap_phase(dev, raw_host)
        serving, launches = serving_phase(dev, root, raw_host)
    k1["launches"] = launches
    serving["card"] = card
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
