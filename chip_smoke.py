#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (handpose_tpu_torch) on one card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the serving and training paths from
   handpose_tpu_torch/csrc, one nvcc per source, all started together;
3. kernel phases: each kernel against its plain PyTorch version on the
   card at the shapes its path gives it and at edge cases, then timed
   with CUDA events beside the least time the card could take (its
   bound) and, where one exists, one PyTorch call computing the same
   function:
   - K1 scoremap (serving and training preprocessing);
   - K2 BatchNorm moments at every BN shape of the b256 trunk, bf16,
     shift 0 and nonzero, each sum to 1e-5 of its scale, bit-identical
     over two runs;
   - K3 stem max-pool backward at the b256 stem shape, odd shapes and a
     tie-heavy input: equal support, within one bf16 ulp;
4. serving phase: a 520-sample synthetic RHD tree in the decoded-cache
   form; the Evaluator at batch 256 (two full batches and one of 8) and
   ``serve`` on one batch, full width (crop 256, 21 input channels, two
   ResNet-18 trunks), bf16 compute, seeded weights.  Checks finite
   outputs, one scoremap launch per batch, agreement with the same
   pipeline with the plain render substituted, agreement of the card with
   the host path (which the CPU tests hold to the JAX package) on a small
   batch, and the ground-truth reprojection of the preprocessing; then
   times the layers;
5. training phase, full width, b256, bf16, bn_variance 'fast', Adam with
   the cosine LR, on the same tree (its one split trains and validates):
   one fused train step through the kernels against the same step from
   the same state with the plain K1, K2 and K3 substituted, held to a
   plain step that sums the moments in another order (the scale of
   float32 rounding carried through bf16 training); then the port's
   ``Worker`` for two epochs (4 train steps, whole-split validation after
   each), with every launch count read around it; then the step's layer
   times and peak memory;
6. prints the ``kernels`` line, the card line and, last, the result line.

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
MOMENTS_RTOL = 1e-5              # of the channel's sum of |x - shift|
# (name, rows, channels, launches per trunk) of every train-mode BN of
# the b256 crop-256 ResNet-18 trunk: 20 per trunk, 40 per step
BN_SHAPES = (("stem", BATCH * 128 * 128, 64, 1),
             ("stage1", BATCH * 64 * 64, 64, 4),
             ("stage2", BATCH * 32 * 32, 128, 5),
             ("stage3", BATCH * 16 * 16, 256, 5),
             ("stage4", BATCH * 8 * 8, 512, 5))
STEM = (BATCH, 64, 128, 128)     # the stem pool's input, NCHW


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


def cuda_ms(fn, iters, hide_host=False):
    """Mean time of ``fn`` over ``iters`` calls after one warm call, from
    CUDA events.  With ``hide_host`` the card first spins for ~25 ms while
    the host queues the calls, so a kernel shorter than its launch's host
    work is timed on the device alone (the kernel phases); without it a
    chain of small host-paced ops is timed as a caller sees it (the
    layers)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(50_000_000)       # cycles, ~25 ms at 1.98 GHz
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
    ms = cuda_ms(lambda: kernel(c, (crop, crop), sigma, v), 20,
                 hide_host=True)
    plain_ms = cuda_ms(lambda: plain(c, (crop, crop), sigma, v), 10,
                       hide_host=True)
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


# ---------------------------------------------------------------------------
# K2: BatchNorm moments


def moments_phase(dev):
    """K2 against its plain version at every BN shape of the b256 trunk
    (bf16, shift 0 and nonzero; each sum to MOMENTS_RTOL of the channel's
    sum of |x - shift|; bit-identical over two runs), then timed."""
    from handpose_tpu_torch.ops import moments, moments_cuda
    kernel, plain = moments_cuda.shifted_moments_cuda, moments.shifted_moments
    g = torch.Generator(device=dev).manual_seed(2)
    max_err, rows = 0.0, []
    for name, N, C, _ in BN_SHAPES:
        x = (torch.randn(N, C, generator=g, device=dev) + 0.5).to(
            torch.bfloat16)
        shift = torch.randn(C, generator=g, device=dev) * 0.1 + 0.25
        for sh in (torch.zeros_like(shift), shift):
            a, b = kernel(x, sh), kernel(x, sh)
            torch.cuda.synchronize()
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"moments kernel deterministic, {name} ({N}, {C})")
            p = plain(x, sh)
            d = x.to(torch.float32) - sh
            scales = (d.abs().sum(0), p[1])
            del d
            rel = max(float(((k - r).abs() / sc).max())
                      for k, r, sc in zip(a, p, scales))
            max_err = max(max_err, max(float((k - r).abs().max())
                                       for k, r in zip(a, p)))
            check(rel <= MOMENTS_RTOL,
                  f"moments kernel == plain, {name} ({N}, {C}), shift "
                  f"{'0' if not sh.any() else 'nonzero'}: {rel:.3g} of "
                  f"sum|x - shift| <= {MOMENTS_RTOL}")
        side = int(round((N // BATCH) ** 0.5))      # the activation's H, W
        x4 = x.view(BATCH, side, side, C).permute(0, 3, 1, 2)
        row = {"name": name, "rows": N, "channels": C,
               "ms": cuda_ms(lambda: kernel(x, shift), 20, hide_host=True),
               "plain_ms": cuda_ms(lambda: plain(x, shift), 5, hide_host=True),
               "library_ms": cuda_ms(lambda: torch.var_mean(
                   x4, dim=(0, 2, 3), correction=0), 20, hide_host=True)}
        n_bytes = N * C * 2 + 3 * C * 4      # x, shift, two (C,) sums
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * N * C / F32_FLOPS * 1e3  # convert-sub, add, mul-add
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"moments {name} ({N}, {C}) bf16: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, var_mean "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
              flush=True)
        rows.append(row)
        del x, x4
    stem = rows[0]
    return {"name": "moments", "route": "cuda",
            "source": "handpose_tpu_torch/csrc/moments.cu",
            "replaces": "handpose_tpu/ops/pallas_kernels.py:120",
            "shape": f"({stem['rows']}, {stem['channels']}) bf16 (stem BN)",
            "max_abs_err": max_err, "ms": stem["ms"],
            "plain_ms": stem["plain_ms"], "bound_ms": stem["bound_ms"],
            "bound_by": stem["bound_by"], "library_ms": stem["library_ms"],
            "library": "torch.var_mean(x, dim=(0, 2, 3), correction=0)",
            "by_shape": rows}


def moments_per_step(k2, by_shape, steps):
    """Each shape's launches in the Worker's run (counted at the launch
    site, by (N, C)) and, from them and the kernel phase's times at that
    shape, the kernel's time per train step."""
    for r in k2["by_shape"]:
        r["launches"] = by_shape[(r["rows"], r["channels"])]
    k2["per_step"] = {k: sum(r[k] * r["launches"] for r in k2["by_shape"])
                      / steps
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"moments per train step ({sum(by_shape.values()) // steps} "
          f"launches): kernel {k2['per_step']['ms']:.4f} ms, bound "
          f"{k2['per_step']['bound_ms']:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# K3: stem max-pool backward


def _ulp(t):
    """One unit in the last place of each element of ``t`` (its dtype)."""
    mant = 7 if t.dtype == torch.bfloat16 else 23
    f = t.to(torch.float32).abs()
    e = torch.floor(torch.log2(torch.where(f > 0, f, torch.ones_like(f))))
    return torch.where(f > 0, torch.exp2(e - mant), torch.zeros_like(f))


def pool_bwd_phase(dev):
    """K3 against its plain version at the b256 stem shape, odd shapes
    and a tie-heavy input (equal support, max |diff| <= one ulp of the
    plain result), then timed."""
    from handpose_tpu_torch.ops import pool_bwd_cuda, pooling
    kernel = pool_bwd_cuda.max_pool_3x3s2p1_bwd_cuda
    plain = pooling.max_pool_3x3s2p1_bwd
    g = torch.Generator(device=dev).manual_seed(3)
    cl = torch.channels_last

    def inputs(shape, dtype, ties=False):
        N, C, H, W = shape
        x = (torch.randint(-2, 3, shape, generator=g, device=dev).float()
             if ties else torch.randn(shape, generator=g, device=dev))
        dy = torch.randn((N, C, (H + 1) // 2, (W + 1) // 2), generator=g,
                         device=dev)
        return (torch.relu(x).to(dtype).contiguous(memory_format=cl),
                dy.to(dtype).contiguous(memory_format=cl))

    max_err = 0.0
    for name, shape, dtype, ties in (
            ("stem b256", STEM, torch.bfloat16, False),
            ("odd", (8, 64, 33, 17), torch.bfloat16, False),
            ("odd f32 C=5", (4, 5, 9, 7), torch.float32, False),
            ("ties", (16, 64, 32, 32), torch.bfloat16, True)):
        x, dy = inputs(shape, dtype, ties)
        out = kernel(x, dy)
        torch.cuda.synchronize()
        ref = plain(x, dy)
        diff = (out.to(torch.float32) - ref.to(torch.float32)).abs()
        err = float(diff.max())
        max_err = max(max_err, err)
        check(torch.equal(out != 0, ref != 0),
              f"pool backward kernel support == plain, {name} {shape}")
        check(bool((diff <= _ulp(ref)).all()),
              f"pool backward kernel == plain within 1 ulp, {name}: max "
              f"|diff| {err:.3g}")
        del out, ref, diff
    x, dy = inputs(STEM, torch.bfloat16)
    y, idx = torch.ops.aten.max_pool2d_with_indices(x, [3, 3], [2, 2],
                                                    [1, 1])
    dy = dy.contiguous(memory_format=cl)
    ms = cuda_ms(lambda: kernel(x, dy), 20, hide_host=True)
    plain_ms = cuda_ms(lambda: plain(x, dy), 5, hide_host=True)
    library_ms = cuda_ms(
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx), 20,
        hide_host=True)
    fwd_idx_ms = cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices(
        x, [3, 3], [2, 2], [1, 1]), 20, hide_host=True)
    n_bytes = 2 * x.numel() * 2 + dy.numel() * 2      # x, dx, dy
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 9 * 2 * dy.numel() / F32_FLOPS * 1e3      # 9 compares a window
    print(f"pool backward {STEM} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, aten backward {library_ms:.4f} ms (its "
          f"forward with indices {fwd_idx_ms:.4f} ms), bound "
          f"{max(t_bytes, t_ops):.4f} ms", flush=True)
    del x, dy, y, idx
    return {"name": "pool_bwd", "route": "cuda",
            "source": "handpose_tpu_torch/csrc/pool_bwd.cu",
            "replaces": "handpose_tpu/ops/pallas_kernels.py:294",
            "shape": f"x {STEM} bf16 channels_last",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": "aten.max_pool2d_with_indices_backward",
            "library_forward_with_indices_ms": fwd_idx_ms}


# ---------------------------------------------------------------------------
# training phase


def _counts():
    from handpose_tpu_torch.ops import moments_cuda, pool_bwd_cuda, \
        scoremap_cuda
    return (scoremap_cuda.KERNEL, moments_cuda.KERNEL, pool_bwd_cuda.KERNEL)


def training_phase(dev, root, raw_host):
    import copy
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.ops import heatmap, moments, pooling
    from handpose_tpu_torch.train import (Worker, compute_losses,
                                          create_train_state,
                                          make_fused_train_step)
    from handpose_tpu_torch.train.steps import _forward

    logs = tempfile.mkdtemp(dir=root)
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_name="RHD", dataset_root_dir=root,
                 batch_size=BATCH, infer_batch_size=BATCH, max_epoch=2,
                 use_val_dataset_to_debug=True, save_log_dir=logs)
    check(cfg.crop_size == 256 and cfg.compute_dtype == "bfloat16"
          and cfg.bn_mode == "fast",
          "training at full width: crop 256, bf16, bn_variance 'fast'")
    raw = raw_host.to(dev)
    pp = serving_kwargs(cfg)

    # ---- one step through the kernels against the plain versions ----
    # Three steps from one seeded state: through the kernels, with the
    # plain versions, and with the plain versions summing the BN moments'
    # rows in reverse order.  The kernels differ from the plain versions
    # by float32 rounding only (tests/test_torch_gpu.py holds the float32
    # step to that); in bf16 such rounding flips single bf16 roundings,
    # which the backward through 18 layers carries into the gradient and
    # Adam's first update (-lr * g / (|g| + eps)) into whole steps of up
    # to lr.  The last pair measures that for the moment sums alone: the
    # yardstick of the first pair, for the gradient and for the share of
    # parameter elements whose updates differ by more than 0.1 lr.
    base = build_model(cfg).to(dev)
    runs = []
    def reversed_sums(x2d, shift):
        return moments.shifted_moments(x2d.flip(0), shift)

    for route in ("kernel", "plain", "plain, rows reversed"):
        plain = route != "kernel"
        model = copy.deepcopy(base)
        state = create_train_state(model, cfg)
        step = make_fused_train_step(model, cfg, preprocess_batch, pp)
        before = [k.launches for k in _counts()]
        render = (heatmap.render_gaussian_maps if plain
                  else pp_mod.render_gaussian_maps_cuda)
        with mock.patch.object(pp_mod, "render_gaussian_maps_cuda",
                               render), \
                mock.patch.object(moments, "_moments", {
                    "kernel": moments._moments,
                    "plain": moments.shifted_moments,
                    "plain, rows reversed": reversed_sums}[route]), \
                mock.patch.object(pooling, "_pool_bwd",
                                  pooling.max_pool_3x3s2p1_bwd
                                  if plain else pooling._pool_bwd):
            _, losses = step(state, raw)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(_counts(), before)]
        check(rose == ([0, 0, 0] if plain else [1, 40, 2]),
              f"{route} step launched K1, K2, K3 {rose} times")
        # Adam's first moment after one update is 0.1 x the gradient
        grad = torch.cat([state.optimizer.state[p]["exp_avg"].flatten()
                          for p in model.parameters()]) / 0.1
        runs.append(({k: float(v) for k, v in losses.items()}, model, grad))
        del state, step
    (lk, mk, gk), (lp, mp, gp), (_, mq, gq) = runs

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    e_loss = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in lk)
    check(e_loss <= 1e-3, f"step losses, kernels vs plain (bf16): "
          f"{e_loss:.3g} relative <= 1e-3")
    e_grad, e_base = rel(gk, gp), rel(gq, gp)
    check(e_grad <= 2 * e_base + 1e-3,
          f"step gradients, kernels vs plain (bf16): {e_grad:.3g} of the "
          f"gradient's norm <= 2 x {e_base:.3g} (plain vs plain with the "
          "moment rows reversed) + 1e-3")
    lr = cfg.lr

    def off_share(ma, mb):
        """Share of parameter elements whose updates differ > 0.1 lr."""
        n_off = sum(int(((a - b).abs() > 0.1 * lr).sum())
                    for a, b in zip(ma.parameters(), mb.parameters()))
        return n_off / sum(p.numel() for p in mb.parameters())

    with torch.no_grad():
        off, off_base = off_share(mk, mp), off_share(mq, mp)
        e_bs = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
                   for a, b in zip(mk.buffers(), mp.buffers()))
    check(off <= 2 * off_base + 1e-3,
          f"step parameter updates, kernels vs plain (bf16): {off:.3%} of "
          f"elements differ by more than 0.1 lr <= 2 x {off_base:.3%} "
          "(plain vs plain with the moment rows reversed) + 0.1%")
    check(e_bs <= 1e-2, f"step BatchNorm statistics, kernels vs plain: "
          f"{e_bs:.3g} of range <= 1e-2")
    step_check = {"loss_rel": e_loss, "grad_rel": e_grad,
                  "grad_rel_plain_vs_reversed_sums": e_base,
                  "update_beyond_0.1lr": off,
                  "update_beyond_0.1lr_plain_vs_reversed_sums": off_base,
                  "batch_stats_rel": e_bs}
    del runs, mk, mp, mq, base, gk, gp, gq
    torch.cuda.empty_cache()

    # ---- the main path: the Worker, two epochs ----
    worker = Worker(cfg, run_dir=logs, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in _counts():
        k.launches = 0
    _counts()[1].by_shape.clear()
    _counts()[2].dy_copies = 0
    t0 = time.perf_counter()
    best = worker.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = [k.launches for k in _counts()]
    k2_shapes = dict(_counts()[1].by_shape)
    dy_copies = _counts()[2].dy_copies
    peak = torch.cuda.max_memory_allocated()
    steps = worker.state.step
    n_val = 2 * -(-N_SAMPLES // BATCH)
    check(steps == 4 and len(worker.step_seconds) == 4,
          f"Worker took {steps} train steps over 2 epochs")
    check(launches == [steps + n_val, 40 * steps, 2 * steps],
          f"Worker run launched K1 {launches[0]} (= {steps} steps + "
          f"{n_val} validation batches), K2 {launches[1]} (= 40 x "
          f"{steps}), K3 {launches[2]} (= 2 x {steps}) times; K3's dy "
          f"was copied into channels_last {dy_copies} times")
    check(k2_shapes == {(N, C): 2 * per_trunk * steps
                        for _, N, C, per_trunk in BN_SHAPES},
          f"Worker run launched K2 at the BN shapes the K2 phase held and "
          f"timed, as often as the two trunks hold them: {k2_shapes}")
    log = open(worker.log_path).read()
    train_lines = [t for t in log.splitlines()
                   if t.startswith("Training Epoch")]
    losses = [float(t.rsplit("loss: ", 1)[1].split(",")[0])
              for t in train_lines]
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"finite epoch training losses {losses}")
    check(np.isfinite(best) and best > 0,
          f"validation MPJPE finite: {best:.4f} mm")

    # ---- layer times of one b256 step, device resident ----
    model, state = worker.model, worker.state
    step = worker.train_step

    def fwd_loss():
        with torch.no_grad():
            batch = preprocess_batch(raw, **pp)
        out = _forward(model, batch, cfg, True)
        return compute_losses(out, batch, cfg)["loss"]

    with torch.no_grad():
        preprocess_ms = cuda_ms(lambda: preprocess_batch(raw, **pp), 5)
    fwd_ms = cuda_ms(fwd_loss, 3)
    step_ms = cuda_ms(lambda: step(state, raw), 3)
    med = float(np.median(worker.step_seconds[1:]))
    training = {
        "steps": steps, "epoch_losses": losses, "val_mpjpe_mm": best,
        "run_s": t_run, "step_s": worker.step_seconds,
        "train_img_per_s_median_after_first": BATCH / med,
        "step_ms": step_ms, "preprocess_ms": preprocess_ms,
        "forward_ms": fwd_ms - preprocess_ms,
        "backward_and_update_ms": step_ms - fwd_ms,
        "max_memory_allocated_bytes": peak,
        "launches": dict(zip(("scoremap", "moments", "pool_bwd"), launches)),
        "step_check": step_check,
        "pool_bwd_dy_layout_copies": dy_copies,
    }
    print(f"training b{BATCH}: {BATCH / med:.1f} img/s (median step "
          f"{med * 1e3:.1f} ms after the first), step {step_ms:.3f} ms = "
          f"preprocess {preprocess_ms:.3f} + forward "
          f"{fwd_ms - preprocess_ms:.3f} + backward and Adam "
          f"{step_ms - fwd_ms:.3f}; validation MPJPE {best:.4f} mm; peak "
          f"{peak} B", flush=True)
    del worker, model, state, step
    torch.cuda.empty_cache()
    return training, launches, k2_shapes


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.ops import (cuda_build, moments_cuda,
                                        pool_bwd_cuda, scoremap_cuda)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = [m.SOURCE for m in (scoremap_cuda, moments_cuda, pool_bwd_cuda)]
    t0 = time.perf_counter()
    logs = cuda_build.build_many(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s (one nvcc "
          "each, together)", flush=True)
    for name, log in logs.items():
        if log:
            print(f"--- nvcc {name}.cu ---\n{log.strip()}", flush=True)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_synthetic_rhd(root, "evaluation", n=N_SAMPLES, seed=0)
        print(f"wrote the {N_SAMPLES}-sample tree in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        raw_host = RHDDataset(root, "evaluation").raw_batch(range(BATCH))
        k1 = scoremap_phase(dev, raw_host)
        k2 = moments_phase(dev)
        k3 = pool_bwd_phase(dev)
        torch.cuda.empty_cache()
        serving, k1_serving = serving_phase(dev, root, raw_host)
        torch.cuda.empty_cache()
        training, (k1_train, k2_train, k3_train), k2_shapes = \
            training_phase(dev, root, raw_host)
    moments_per_step(k2, k2_shapes, training["steps"])
    k1["launches"] = k1_serving + k1_train
    k1["launches_by_path"] = {"serving": k1_serving, "training": k1_train}
    k2["launches"] = k2_train
    k3["launches"] = k3_train
    serving["card"] = card
    training["card"] = card
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
