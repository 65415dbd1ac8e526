#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (handpose_tpu_torch) on one card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the serving and training paths from
   handpose_tpu_torch/csrc, and the host image codecs (csrc/imageio.cpp,
   g++), one compiler per source, all started together;
3. decode phase: a 520-sample RHD tree of PNGs from the port's writer;
   its decoded cache built (timed) and equal to the written pixels; the
   PNG pair decode rate; a smooth 512x334 frame through the JPEG writer
   and decoder within quantisation (PSNR >= 40 dB); five Evaluator passes
   decoding the PNGs against five on the cache;
4. kernel phases: each kernel against its plain PyTorch version on the
   card at the shapes its path gives it and at edge cases, then timed
   with CUDA events beside the least time the card could take (its
   bound) and, where one exists, one PyTorch call computing the same
   function:
   - K1 scoremap (serving and training preprocessing), also on the
     coordinates uv and crop noise give it (fractional, below -1, in
     (-1, 0), past H - 1);
   - K2 BatchNorm moments at every BN shape of the b256 ResNet-18 and
     ResNet-50 trunks (17 shapes, C up to 2048), bf16, shift 0 and
     nonzero, each sum to 1e-5 of its scale, bit-identical over two runs,
     and in float32 at the widest rows (C = 2048 and 1024);
   - K3 stem max-pool backward at the b256 stem shape, the float32 stem
     at b16, odd and tile-edge shapes, C = 5 and 3 and a tie-heavy input:
     equal support, within one ulp; timed, with its registers and
     resident blocks per SM;
5. serving phase: the tree through its decoded cache; the Evaluator at
   batch 256 (two full batches and one of 8) and ``serve`` on one batch,
   full width (crop 256, 21 input channels, two ResNet-18 trunks), bf16
   compute, seeded weights.  Checks finite outputs, one scoremap launch
   per batch, agreement with the same pipeline with the plain render
   substituted, agreement of the card with the host path (which the CPU
   tests hold to the JAX package) on a small batch, and the ground-truth
   reprojection of the preprocessing; then times the layers;
6. training phase, full width, b256, bf16, bn_variance 'fast', Adam with
   the cosine LR, on the same tree (its one split trains and validates):
   one fused train step through the kernels against the same step from
   the same state with the plain K1, K2 and K3 substituted, held to a
   plain step that sums the moments in another order (the scale of
   float32 rounding carried through bf16 training); then the port's
   ``Worker`` for two epochs (4 train steps, whole-split validation after
   each), with every launch count read around it; then the step's layer
   times (from the spans inside the step, ``utils/tracing.py``) and peak
   memory;
7. augmented training phase: the same Worker with all six train-time
   augmentations on (uv, crop centre, scale and offset noise, hue,
   scoremap dropout, drawn on the card): launch counts as in 6, finite
   losses, the draws' statistics over the run (dropout keep share 0.2 +-
   0.001, uv noise std 2.5 +- 0.05 px); its checkpoint/ and model_best/
   (write time, bytes); a second Worker resumed from checkpoint/, whose
   params, statistics and Adam state must be bit-equal; the Evaluator on
   model_best/, whose MPJPE must equal the run's best exactly; then the
   step's layer times beside the plain step's;
8. preemption phase (``steps_per_dispatch=1``): a request inside step 3
   pins the checkpoint to epoch 1, and a Worker resumed from it restarts
   epoch 1 from the preempted state (bit-equal) and runs it to the end;
8'. data parallelism and the Worker's knobs, full width, b256 (the
   comparisons under deterministic cuDNN, so that two runs of one
   computation are bit-equal):
   (a) the augmented Worker inside a process group of one rank over
       NCCL, two epochs: its state bit-equal (bound 1e-6 of range) to the
       same Worker's without a group, the launch counts of 6, 40
       all-reduces of BatchNorm sums a step, its step and the plain
       Worker's timed in turns;
   (b) two ranks on the one card (spawned processes, gloo), float32,
       TF32 off, the global b256 with all six augmentations: two fused
       steps against the 1-process steps on the same global batch
       (within twice the yardstick: the 1-process steps with reversed
       BatchNorm sums),
       parameters and statistics bit-equal on the ranks, a Worker's
       padded validation one MPJPE on both, equal (1e-9) to the
       1-process eval step over the same shards summed in float64, and
       a preemption request on rank 1 alone stopping both ranks at one
       boundary, rank 0 alone writing;
   (c) the Worker with ``remat``: two steps equal to the plain Worker's,
       K2 80 a step, the step's time and peak memory beside the plain
       step's; DiffusionHandPose at b8 under torch's deterministic
       algorithms, in a process of its own (cuBLAS's workspace setting
       for them stays out of the other phases), one remat step equal to
       the plain one (its gradient within twice the distance of two
       plain steps, both 0 there), the generator advanced once;
   (d) ``steps_per_dispatch`` 2 (a full group an epoch) and 8 (all tail):
       the dispatches and step counts, the states equal, a request while
       a group is buffered dropping it;
   (e) ``debug_nans``: the Worker's step time with it on; a NaN planted in
       one conv kernel raises ``FloatingPointError`` naming the module;
   (f) four ranks on the one card (spawned processes, gloo), dp 2 x tp 2
       (``parallel/sharding.py``), float32, TF32 off: the dry run
       (``parallel/dryrun.py``, the global b128 of the JAX body's seeded
       frames with all six augmentations, two fused steps) against the
       1-process steps on the same batch (within twice (b)'s yardstick,
       the step-1 gradients gathered whole included), the state and
       those gradients gathered whole bit-equal on the four ranks, each
       sharded parameter and its Adam moments stored as half its rows,
       each rank's parameter and Adam bytes beside the replicated
       state's (within 5% of the rule's prediction, -49.8%); a Worker
       with ``mesh_shape=(2, 2)`` for one epoch at the default cuDNN
       settings, its padded validation one MPJPE on all four ranks,
       equal (1e-9) to the 1-process eval step over the two data shards
       summed in float64;
8a. export phase: the flagship's fused serving program (full width, b256,
   seeded init) exported with ``torch.export`` on the card and saved;
   a process that imports only torch, numpy and the port's ops loads it,
   finds one call of K1's operator, launches K1 once a call, and its
   (xyz, uv) equal eager ``serve`` on the same raw batch to 1e-6 of
   range; export and load seconds, artifact bytes, and the loaded
   program's b256 rate beside eager serving's (median of 25 calls);
   DiffusionHandPose's forward exported at b8 on its default ladder
   (T 400, DDIM 200) and held to ``serve`` to 1e-5 of range;
8b. ops phase: the ops library that no path calls (camera conversions,
   projections, ``flip_right_hand``, ``bone_rel_trafo_inv``, the 3-D
   heatmap, the affine warp at 64 x 256 x 256 x 3, the heatmap-space
   transform), card vs host, 1e-6 of range (the warp 1e-5);
8c. inference CLI phase: ``python -m handpose_tpu_torch.infer``'s main
   with ``--from_run`` on the augmented run, with ``--pck`` and then
   with ``--visualize_dir`` (each == the run's best MPJPE exactly; the 8
   overlays decode at the crop's size), and ``--export`` (loads, runs);
8d. profile phase: a fast_debug Worker with ``profile_epoch=0`` writes a
   chrome trace under ``run_dir/profile/`` naming K1, K2 and K3;
9. InterHand2.6M serving phase: a synthetic tree of 2 x 520 JPEG frames
   of 512x334, one in four 334x512 (``pad_to="auto"`` pads them to
   512x512); the val split's cache (timed) and its JPEG decode rate; K1
   on the InterHand coordinates against its plain version (<= 1e-6);
   the Evaluator's ``evaluate_full`` (one K1 launch a batch, finite
   MPJPE, a PCK curve that never falls) and ``serve``; card against host
   (f32); the device-resident b256 serving rate; five Evaluator passes
   decoding the JPEGs against five on the cache;
10. InterHand training phase: the Worker at b256 with its two
   augmentations (uv noise, scoremap dropout), two epochs through the
   caches: launch counts as in 6, the dropout's keep share, the
   Evaluator on model_best equal to the run's best, the step's split and
   peak memory;
11. ResNet-50 serving phase: Hand3DPoseNet at full width (crop 256, 3
   input channels, 1024-d features, bf16, the k3s2 stem) through the
   Evaluator (one K1 launch a batch) and ``serve``, the card against the
   host (f32, b4), the device-resident b256 rate and its layers;
12. ResNet-50 training phases: the Worker of Hand3DPoseNet,
   OnlyThreeDimHandPose and TwoDimHandPose at b256, two epochs of two
   steps each: K1 once a step or batch, K2 53 times a step at the 12
   ResNet-50 BN shapes the K2 phase held, K3 once a step, tiled; finite
   losses with exactly the terms of each model's gates (``loss_uv`` in
   pixels, over 1e5 in the total); the Evaluator on model_best equal to
   the run's best; the step's split and peak memory;
13. stems phase: the ResNet-50 trunk under k3s2_s2d equal to k3s2 with
   the same weights (f32, TF32 off, 1e-5 of range); each stem's conv and
   trunk forward timed at b256; Hand3DPoseNet with the k7s2 stem trains
   one fused step through K1, K2 and K3;
14. FK and MANO phase: which MANO is used (the synthetic stand-in unless
   a MANO_RIGHT.pkl is found); FK on the card equal to
   tests/fixtures/fk.npz (the torch reference's outputs) at both joint
   orders (xyz atol 2e-5; uv rtol 1e-4, atol 5e-2); the MANO layer at
   b256 on the card equal to the host's float32 run to 1e-5 of range for
   pose_num 6, 10 and 45; ``rodrigues`` at |r| = 0, 1e-20 and 1e-3 card
   vs host (1e-6) with the branch the card takes; ``hand_mask_loss`` on
   uv out of int32's range or not finite, one value on the card and the
   host;
15. the FK and MANO models at full width (crop 256, bf16, the CLIs'
   default input channels: 3 for TwoDimHandPoseWithFK, ThreeDimHandPose
   and MANO3DHandPose, 24 for ThreeHandShapeAndPoseMANO and
   Resnet50MANO3DHandPose; MANO pose_num 10), each as 11 and 12 do:
   serving (the Evaluator, ``serve`` at b256 device resident, its
   layers), the card against the host (f32, b4 crop 64, in two parts:
   the geometry's inputs, then the outputs from the host's geometry
   inputs), and the Worker for one epoch of two steps with validation
   (K2 36 a step at the flagship's 5 shapes for ResNetMano, 53 for the
   ResNet-50 trunks; the loss terms of each model's gates);
16. diffusion phase: the sampler of DiffusionHandPose at full width
   (Unet1D dim 64, mults 1/2/4/8, 256-d condition, T 400, DDIM 200),
   float32, the main path's seeded model conditioned on its trunk's
   features of the tree's images: ``Unet1D`` card vs host (plain and time-table modes, 1e-5);
   the full DDIM ladder and a DDPM pass at T 20 from injected draws,
   card vs host within twice the larger float32-vs-float64 distance of
   the two devices plus 1e-5; hoisted against unhoisted at b32 (twice
   the card's own float32-vs-float64 distance plus 1e-5); at b256 the
   time of a pass and of a denoise step, the kernels a step launches and
   their device time (``torch.profiler``), the device's busy share, and
   a hoisted b32 pass;
17. DiffusionHandPose at full width (3 channels, the ResNet-50 k3s2
   trunk, bf16, the 200-step sampler on every forward) as 15 does:
   serving (the Evaluator, ``serve``, its layers), the card against the
   host in three parts (the sample; the bone heads on the host's sample;
   the outputs from the host's bone heads; f32, b4 crop 64), and the
   Worker for one epoch of two steps with validation (K1 once a step or
   batch, K2 53 a step at the ResNet-50 shapes, K3 once a step; the
   ``loss_xyz`` and ``loss_diffusion`` terms; the Evaluator on
   model_best equal to the run's best; the sampler's share of the
   forward);
18. prints the ``kernels`` line (launches summed over every path, the
   exported program's one launch a call among them; K2's
   time per step of the flagship, of ResNet-50 and of ResNetMano), the
   card line and, last, the result line.

Any failed check raises, so the script exits non-zero; without a card, or
without the package beside it, it exits non-zero before printing results.
Imports nothing of JAX.
"""

import contextlib
import json
import os
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
# the same for the b256 crop-256 ResNet-50 trunk of Hand3DPoseNet,
# OnlyThreeDimHandPose and TwoDimHandPose: 53 per step at 12 shapes,
# C = 2048 (K2's float32 limit) included
BN50_SHAPES = (("stem", BATCH * 128 * 128, 64, 1),
               ("stage1", BATCH * 64 * 64, 64, 6),
               ("stage1 out", BATCH * 64 * 64, 256, 4),
               ("stage2 in", BATCH * 64 * 64, 128, 1),
               ("stage2", BATCH * 32 * 32, 128, 7),
               ("stage2 out", BATCH * 32 * 32, 512, 5),
               ("stage3 in", BATCH * 32 * 32, 256, 1),
               ("stage3", BATCH * 16 * 16, 256, 11),
               ("stage3 out", BATCH * 16 * 16, 1024, 7),
               ("stage4 in", BATCH * 16 * 16, 512, 1),
               ("stage4", BATCH * 8 * 8, 512, 5),
               ("stage4 out", BATCH * 8 * 8, 2048, 4))
# (N, C) that K2 is also held at in float32: the widest rows
F32_MOMENT_SHAPES = ((BATCH * 8 * 8, 2048), (BATCH * 16 * 16, 1024))
STEM = (BATCH, 64, 128, 128)     # the stem pool's input, NCHW
# the b256 crop-256 ResNetMano trunk of ThreeHandShapeAndPoseMANO
# (BasicBlock x [3, 4, 6, 3]): 36 per step at the flagship's 5 shapes
BN_MANO_SHAPES = (("stem", BATCH * 128 * 128, 64, 1),
                  ("stage1", BATCH * 64 * 64, 64, 6),
                  ("stage2", BATCH * 32 * 32, 128, 9),
                  ("stage3", BATCH * 16 * 16, 256, 13),
                  ("stage4", BATCH * 8 * 8, 512, 7))
# the ResNet-50 models on the RHD tree: 3 input channels (the image crop)
RESNET50_MODELS = ("Hand3DPoseNet", "OnlyThreeDimHandPose",
                   "TwoDimHandPose")
# the FK and MANO models on the RHD tree, each at its CLI's default
# input channels: 3, or 24 (image and scoremaps) for the last two
FK_MANO_MODELS = ("TwoDimHandPoseWithFK", "ThreeDimHandPose",
                  "MANO3DHandPose", "ThreeHandShapeAndPoseMANO",
                  "Resnet50MANO3DHandPose")
DIFFUSION = "DiffusionHandPose"


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


def cuda_ms(fn, iters, hide_host=False, warm=True):
    """Mean time of ``fn`` over ``iters`` calls after one warm call
    (``warm=False``: none, for a call the caller has already made at
    these shapes), from CUDA events.  With ``hide_host`` the card first spins for ~25 ms while
    the host queues the calls, so a kernel shorter than its launch's host
    work is timed on the device alone (the kernel phases); without it a
    chain of small host-paced ops is timed as a caller sees it (the
    layers)."""
    if warm:
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
        # the training path's coordinates under uv and crop noise, drawn
        # on the card as the augmented Worker draws them, with a few set
        # where the noise can put them: in (-1, 0), below -1, past H - 1
        g = torch.Generator(device=dev).manual_seed(11)
        s = preprocess_batch(raw_host.to(dev), crop_size=crop, sigma=sigma,
                             switch_joint_order=False, coord_uv_noise=True,
                             crop_center_noise=True, crop_scale_noise=True,
                             crop_offset_noise=True, generator=g)
        aug_coords = torch.stack([s["keypoint_uv21"][..., 1],
                                  s["keypoint_uv21"][..., 0]], -1)
        aug_vis = s["keypoint_vis21"].contiguous()
        del s
        aug_coords[0, :6] = torch.tensor(
            [[-0.4, 7.3], [-0.999, crop - 0.5], [-3.2, 40.6],
             [crop - 0.5, 12.25], [crop - 1 + 1e-3, -0.25],
             [crop + 5.5, crop - 1.5]], device=dev)
        aug_vis[0, :6] = True
        aug_coords = aug_coords.contiguous()
    frac = aug_coords - aug_coords.floor()
    check(bool((frac > 0).any() and (aug_coords < -1).any()
               and ((aug_coords > -1) & (aug_coords < 0)).any()
               and (aug_coords > crop - 1).any()),
          "augmented coordinates hold fractional values, values below -1, "
          "in (-1, 0) and past H - 1")
    plain = heatmap.render_gaussian_maps
    cases = [("serving", serving_coords, serving_vis, (crop, crop)),
             ("augmented training", aug_coords, aug_vis, (crop, crop))]
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
                 infer_batch_size=BATCH, cache_decoded=True)
    check(cfg.crop_size == 256 and cfg.compute_dtype == "bfloat16",
          "full width: crop 256, bf16 compute, f32 params")
    ds = RHDDataset(root, "evaluation", cache_decoded=True)
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
    """K2 against its plain version at every BN shape of the b256 ResNet-18
    and ResNet-50 trunks (bf16, shift 0 and nonzero; each sum to
    MOMENTS_RTOL of the channel's sum of |x - shift|; bit-identical over
    two runs), and in float32 at the widest rows (C = 2048 needs all 512
    threads of a block for one row), then timed in bf16."""
    from handpose_tpu_torch.ops import moments, moments_cuda
    kernel, plain = moments_cuda.shifted_moments_cuda, moments.shifted_moments
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = {}
    for name, N, C, _ in BN_SHAPES + BN50_SHAPES:
        shapes.setdefault((N, C), name)
    max_err, rows = 0.0, []

    def hold(x, shift, what):
        nonlocal max_err
        for sh in (torch.zeros_like(shift), shift):
            a, b = kernel(x, sh), kernel(x, sh)
            torch.cuda.synchronize()
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"moments kernel deterministic, {what}")
            p = plain(x, sh)
            d = x.to(torch.float32) - sh
            scales = (d.abs().sum(0), p[1])
            del d
            rel = max(float(((k - r).abs() / sc).max())
                      for k, r, sc in zip(a, p, scales))
            max_err = max(max_err, max(float((k - r).abs().max())
                                       for k, r in zip(a, p)))
            check(rel <= MOMENTS_RTOL,
                  f"moments kernel == plain, {what}, shift "
                  f"{'0' if not sh.any() else 'nonzero'}: {rel:.3g} of "
                  f"sum|x - shift| <= {MOMENTS_RTOL}")

    for (N, C), name in shapes.items():
        x32 = torch.randn(N, C, generator=g, device=dev) + 0.5
        x = x32.to(torch.bfloat16)
        shift = torch.randn(C, generator=g, device=dev) * 0.1 + 0.25
        hold(x, shift, f"{name} ({N}, {C}) bf16")
        if (N, C) in F32_MOMENT_SHAPES:
            hold(x32, shift, f"{name} ({N}, {C}) f32")
        del x32
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


def moments_per_step(k2, by_shape, steps, what):
    """From one Worker run's launches of K2 (counted at the launch site, by
    (N, C)) and the kernel phase's times at each shape: the kernel's time
    per train step (``k2["per_step_" + what]``); each shape's row adds
    the run's launches."""
    rows = {(r["rows"], r["channels"]): r for r in k2["by_shape"]}
    for shape, n in by_shape.items():
        r = rows[shape]
        r["launches"] = r.get("launches", 0) + n
    per = {k: sum(rows[shape][k] * n for shape, n in by_shape.items())
           / steps for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    k2[f"per_step_{what}"] = per
    print(f"moments per {what} train step ({sum(by_shape.values()) // steps}"
          f" launches): kernel {per['ms']:.4f} ms, bound "
          f"{per['bound_ms']:.4f} ms, var_mean {per['library_ms']:.4f} ms",
          flush=True)


# ---------------------------------------------------------------------------
# K3: stem max-pool backward


def _ulp(t):
    """One unit in the last place of each element of ``t`` (its dtype)."""
    mant = 7 if t.dtype == torch.bfloat16 else 23
    f = t.to(torch.float32).abs()
    e = torch.floor(torch.log2(torch.where(f > 0, f, torch.ones_like(f))))
    return torch.where(f > 0, torch.exp2(e - mant), torch.zeros_like(f))


def pool_bwd_phase(dev):
    """K3 against its plain version at the b256 stem shape, odd shapes,
    tile-edge shapes (H, W one past and one short of a 16-pixel tile),
    C = 5 and 3, the float32 stem at b16 and a tie-heavy input (equal
    support, max |diff| <= one ulp of the plain result), then timed at
    the stem shape; registers and resident blocks per SM from the card."""
    from handpose_tpu_torch.ops import cuda_build, pool_bwd_cuda, pooling
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
    bf16, f32 = torch.bfloat16, torch.float32
    for name, shape, dtype, ties in (
            ("stem b256", STEM, bf16, False),
            ("stem b16 f32", (16,) + STEM[1:], f32, False),
            ("odd", (8, 64, 33, 17), bf16, False),
            ("odd f32 C=5", (4, 5, 9, 7), f32, False),
            ("odd C=3", (4, 3, 9, 7), bf16, True),
            ("tile edge -1/+1", (8, 64, 31, 17), bf16, True),
            ("tile edge +1/-1", (8, 64, 33, 15), f32, False),
            ("ties", (16, 64, 32, 32), bf16, True)):
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
    plan = pool_bwd_cuda.KERNEL.plan(x, cuda_build.vector_width(x, dy))
    blocks_per_sm, registers = pool_bwd_cuda.KERNEL.occupancy(plan, x.dtype)
    check(plan.variant == "tiled", f"the stem shape takes the tiled variant "
          f"({plan.th}x{plan.tw} windows a tile, {plan.smem} B of shared "
          f"memory, {registers} registers, {blocks_per_sm} blocks per SM)")
    y, idx = torch.ops.aten.max_pool2d_with_indices(x, [3, 3], [2, 2],
                                                    [1, 1])
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
            "library_forward_with_indices_ms": fwd_idx_ms,
            "variant": plan.variant,
            "tile": [plan.th, plan.tw],
            "block": list(plan.block), "grid": plan.grid,
            "smem_bytes": plan.smem, "registers": registers,
            "blocks_per_sm": blocks_per_sm}


# ---------------------------------------------------------------------------
# training phase


def _counts():
    from handpose_tpu_torch.ops import moments_cuda, pool_bwd_cuda, \
        scoremap_cuda
    return (scoremap_cuda.KERNEL, moments_cuda.KERNEL, pool_bwd_cuda.KERNEL)


def step_split(worker, raw, sampler=None):
    """Layer times of one b256 step on the Worker's path (its
    augmentations drawn from its generator), device resident, from the
    port's spans inside the step (``utils/tracing.py``): three of the
    Worker's steps after a warm one under a profiler session that traces
    the card alone, each phase the device time between its span's events,
    per step: the step, preprocessing, forward and loss, backward and
    Adam.  A model with a sampler (DiffusionHandPose) runs it under
    ``no_grad`` on every forward, ~4 s a pass paced by the host, whose
    spread from call to call exceeds the rest of the step: ``sampler`` is
    then (ms, sample) of a pass the Worker's run timed; the steps run with
    that sample replayed (the same heads, FK and losses, and no gradient
    either way), and its time (``sampler_ms``) is added to the forward
    and the step."""
    from torch.profiler import ProfilerActivity, profile

    from handpose_tpu_torch.utils.tracing import RECORDER
    state, g = worker.state, worker.generator
    sampler_ms, replay = 0.0, contextlib.nullcontext()
    if sampler is not None:
        sampler_ms, sample = sampler
        replay = mock.patch.object(worker.model.diff_model, "sample",
                                   lambda *a, **kw: sample)
    with replay:
        worker.train_step(state, raw, generator=g)
        torch.cuda.synchronize()
        RECORDER.clear()
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(3):
                worker.train_step(state, raw, generator=g)
            torch.cuda.synchronize()
    phases = RECORDER.phases("hp.train.step")
    RECORDER.clear()

    def ms(name):
        return phases[f"hp.train.{name}"]["device_ms"]

    split = {"step_ms": ms("step") + sampler_ms,
             "preprocess_ms": ms("preprocess"),
             "forward_ms": ms("forward") + sampler_ms,
             "backward_and_update_ms": ms("backward") + ms("update")}
    if sampler_ms:
        split["sampler_ms"] = sampler_ms
        split["sampler_share_of_forward"] = sampler_ms / split["forward_ms"]
    return split


def train_config(root, logs, **kw):
    """The flagship at full width on the tree, b256, two epochs of two
    steps (the tree's one split trains and validates)."""
    from handpose_tpu_torch import Config
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  dataset_name="RHD", dataset_root_dir=root,
                  batch_size=BATCH, infer_batch_size=BATCH, max_epoch=2,
                  use_val_dataset_to_debug=True, save_log_dir=logs,
                  cache_decoded=True, **kw)


def reset_counts():
    k1, k2, k3 = _counts()
    for k in (k1, k2, k3):
        k.launches = 0
    k2.by_shape.clear()
    k3.dy_copies = 0
    k3.by_variant.clear()


def check_worker_launches(worker, what, bn_shapes=BN_SHAPES, trunks=2):
    """The launch counts of a Worker's run from reset_counts(): K1 once a
    step or validation batch, K2 at the held BN shapes of its ``trunks``
    trunks (40 a step for the flagship's two ResNet-18s, 53 for one
    ResNet-50), K3 once a trunk and step, all tiled, dy never copied."""
    k1, k2, k3 = _counts()
    steps = worker.state.step
    n_val = worker.cfg.max_epoch * -(-len(worker.val_ds) // BATCH)
    per_step = trunks * sum(n for _, _, _, n in bn_shapes)
    launches = [k1.launches, k2.launches, k3.launches]
    check(launches == [steps + n_val, per_step * steps, trunks * steps],
          f"{what}: launched K1 {launches[0]} (= {steps} steps + {n_val} "
          f"validation batches), K2 {launches[1]} (= {per_step} x {steps}), "
          f"K3 {launches[2]} (= {trunks} x {steps}) times")
    check(dict(k3.by_variant) == {"tiled": trunks * steps}
          and k3.dy_copies == 0,
          f"{what}: K3 only through the tiled variant ({dict(k3.by_variant)})"
          f", dy never copied into channels_last ({k3.dy_copies})")
    check(dict(k2.by_shape) == {(N, C): trunks * n * steps
                                for _, N, C, n in bn_shapes},
          f"{what}: K2 at the BN shapes the K2 phase held and timed, as "
          f"often as the trunks hold them: {dict(k2.by_shape)}")
    return launches


def epoch_losses(worker):
    lines = [t for t in open(worker.log_path).read().splitlines()
             if t.startswith("Training Epoch")]
    return [float(t.rsplit("loss: ", 1)[1].split(",")[0]) for t in lines]


def training_phase(dev, root, raw_host):
    import copy
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.ops import heatmap, moments, pooling
    from handpose_tpu_torch.train import (Worker, create_train_state,
                                          make_fused_train_step)

    logs = tempfile.mkdtemp(dir=root)
    cfg = train_config(root, logs)
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
    reset_counts()
    t0 = time.perf_counter()
    best = worker.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    k2_shapes = dict(_counts()[1].by_shape)
    k3_variants = dict(_counts()[2].by_variant)
    dy_copies = _counts()[2].dy_copies
    peak = torch.cuda.max_memory_allocated()
    steps = worker.state.step
    check(steps == 4 and len(worker.stats.train_seconds) == 4,
          f"Worker took {steps} train steps over 2 epochs")
    launches = check_worker_launches(worker, "Worker run")
    losses = epoch_losses(worker)
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"finite epoch training losses {losses}")
    check(np.isfinite(best) and best > 0,
          f"validation MPJPE finite: {best:.4f} mm")

    # ---- layer times of one b256 step, device resident ----
    split = step_split(worker, raw)
    med = float(np.median(worker.stats.train_seconds[1:]))
    training = {
        "steps": steps, "epoch_losses": losses, "val_mpjpe_mm": best,
        "run_s": t_run, "step_s": worker.stats.train_seconds,
        "median_step_ms_after_first": med * 1e3,
        "train_img_per_s_median_after_first": BATCH / med,
        **split,
        "max_memory_allocated_bytes": peak,
        "launches": dict(zip(("scoremap", "moments", "pool_bwd"), launches)),
        "step_check": step_check,
        "pool_bwd_dy_layout_copies": dy_copies,
        "pool_bwd_launches_by_variant": k3_variants,
    }
    print(f"training b{BATCH}: {BATCH / med:.1f} img/s (median step "
          f"{med * 1e3:.1f} ms after the first), step {split['step_ms']:.3f}"
          f" ms = preprocess {split['preprocess_ms']:.3f} + forward "
          f"{split['forward_ms']:.3f} + backward and Adam "
          f"{split['backward_and_update_ms']:.3f}; validation MPJPE "
          f"{best:.4f} mm; peak {peak} B", flush=True)
    del worker
    torch.cuda.empty_cache()
    return training, launches, k2_shapes


def same_state(a, b):
    """(variables equal, Adam's moments and steps equal), bit for bit."""
    from handpose_tpu_torch.convert import export_flax_variables
    va, vb = export_flax_variables(a.model), export_flax_variables(b.model)
    same_vars = sorted(va) == sorted(vb) and all(
        np.array_equal(va[k], vb[k]) for k in va)
    sa, sb = a.state.optimizer.state, b.state.optimizer.state
    same_adam = all(
        torch.equal(sa[p][k], sb[q][k])
        for p, q in zip(a.model.parameters(), b.model.parameters())
        for k in ("exp_avg", "exp_avg_sq", "step"))
    return same_vars, same_adam


def augmented_training_phase(dev, root, raw_host, plain):
    """The main path with all six augmentations: the Worker for two
    epochs, its launches and the draws' statistics; then its checkpoint
    (write time, size), a second Worker resumed from it (bit-equal
    state), the Evaluator on model_best (equal to the best validation
    MPJPE); then the step's layer times beside the plain step's.  Returns
    the run directory (``config.json``, ``checkpoint/``, ``model_best/``)
    besides its record and launches."""
    import os
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.infer import Evaluator
    from handpose_tpu_torch.train import Worker, trainer

    logs = tempfile.mkdtemp(dir=root)
    cfg = train_config(root, logs, **{f: True for f in trainer.AUG_FLAGS})
    raw = raw_host.to(dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    stats = {"keep": zero.clone(), "elements": zero.clone(),
             "uv_sq": zero.clone(), "uv_n": zero.clone()}
    draw = pp_mod.draw_augmentations

    def counting_draw(flags, shapes, generator):
        d = draw(flags, shapes, generator)
        stats["keep"] += d.dropout_keep.sum()
        stats["elements"] += d.dropout_keep.numel()
        stats["uv_sq"] += d.uv_noise.double().square().sum()
        stats["uv_n"] += d.uv_noise.numel()
        return d

    write_s = []
    save = trainer.save_checkpoint

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        save(*args, **kw)
        write_s.append(time.perf_counter() - t0)

    # ---- the main path: the augmented Worker, two epochs ----
    worker = Worker(cfg, device=dev)
    run = worker.run_dir
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(pp_mod, "draw_augmentations", counting_draw), \
            mock.patch.object(trainer, "save_checkpoint", timed_save):
        best = worker.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = worker.state.step
    check(steps == 4, f"augmented Worker took {steps} train steps over 2 "
          "epochs")
    launches = check_worker_launches(worker, "augmented Worker run")
    losses = epoch_losses(worker)
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"augmented Worker: finite epoch training losses {losses}")
    check(np.isfinite(best) and best > 0,
          f"augmented Worker: validation MPJPE finite: {best:.4f} mm")
    keep = float(stats["keep"] / stats["elements"])
    uv_std = float((stats["uv_sq"] / stats["uv_n"]).sqrt())
    check(abs(keep - 0.2) <= 1e-3, f"dropout keep share over the run "
          f"{keep:.6f} = 0.2 +- 0.001 ({int(stats['elements'])} elements)")
    check(abs(uv_std - 2.5) <= 0.05, f"uv noise std over the run "
          f"{uv_std:.4f} = 2.5 +- 0.05 px ({int(stats['uv_n'])} draws)")

    # ---- checkpoint, resume, Evaluator on model_best ----
    ckpt = os.path.join(run, "checkpoint")
    sizes = {d: sum(os.path.getsize(os.path.join(run, d, f))
                    for f in os.listdir(os.path.join(run, d)))
             for d in ("checkpoint", "model_best")}
    check(len(write_s) == 2 and all(sizes.values()),
          f"checkpoint/ and model_best/ written at each epoch's end: "
          f"{[round(t, 3) for t in write_s]} s, {sizes} B")
    t0 = time.perf_counter()
    resumed = Worker(cfg.replace(resume_weight_path=ckpt),
                     run_dir=tempfile.mkdtemp(dir=root), device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    same_vars, same_adam = same_state(worker, resumed)
    check(same_vars and same_adam,
          "resumed Worker: params, batch_stats and Adam's moments and steps "
          "bit-equal to the run's")
    check(resumed.start_epoch == 2 and resumed.state.step == 4,
          f"resumed Worker: start_epoch {resumed.start_epoch} == 2, schedule "
          f"count {resumed.state.step} == 2 x 2")
    del resumed
    ev_mpjpe = Evaluator(cfg, weights=os.path.join(run, "model_best"),
                         device=dev).evaluate()
    check(ev_mpjpe == best, f"Evaluator on model_best: {ev_mpjpe!r} mm == "
          f"the Worker's best validation MPJPE {best!r}")

    # ---- layer times, beside the plain step's ----
    split = step_split(worker, raw)
    med = float(np.median(worker.stats.train_seconds[1:]))
    augmented = {
        "steps": steps, "epoch_losses": losses, "val_mpjpe_mm": best,
        "evaluator_model_best_mpjpe_mm": ev_mpjpe, "run_s": t_run,
        "step_s": worker.stats.train_seconds,
        "median_step_ms_after_first": med * 1e3,
        "train_img_per_s_median_after_first": BATCH / med,
        **split,
        "augmented_minus_plain_step_ms": split["step_ms"] - plain["step_ms"],
        "max_memory_allocated_bytes": peak,
        "launches": dict(zip(("scoremap", "moments", "pool_bwd"), launches)),
        "dropout_keep_share": keep, "uv_noise_std_px": uv_std,
        "checkpoint_write_s": write_s, "checkpoint_bytes": sizes,
        "resume_s": resume_s,
    }
    print(f"augmented training b{BATCH}: median step {med * 1e3:.1f} ms "
          f"after the first (plain {plain['median_step_ms_after_first']:.1f})"
          f", step {split['step_ms']:.3f} ms (plain {plain['step_ms']:.3f}) "
          f"= preprocess {split['preprocess_ms']:.3f} (plain "
          f"{plain['preprocess_ms']:.3f}) + forward {split['forward_ms']:.3f}"
          f" + backward and Adam {split['backward_and_update_ms']:.3f}; "
          f"checkpoint write {write_s} s, {sizes} B, resume {resume_s:.3f} "
          f"s; peak {peak} B", flush=True)
    del worker
    torch.cuda.empty_cache()
    return augmented, launches, run


def preemption_phase(dev, root):
    """A request inside step 3 (epoch 1, iter 0): the checkpoint is
    pinned to epoch 1, and a Worker resumed from it restarts epoch 1 and
    runs it to the end."""
    import os
    from handpose_tpu_torch.train import PreemptionGuard, Worker, trainer

    logs = tempfile.mkdtemp(dir=root)
    # the single-step boundary: JAX's rule at steps_per_dispatch=1 (the
    # group rule is the groups phase's)
    cfg = train_config(root, logs, steps_per_dispatch=1,
                       **{f: True for f in trainer.AUG_FLAGS})
    worker = Worker(cfg, run_dir=logs, device=dev)
    guard = worker.enable_preemption_save(PreemptionGuard(signals=()))
    calls = [0]
    step = worker.train_step

    def requesting_step(state, raw, **kw):
        calls[0] += 1
        if calls[0] == 3:
            guard.request()
        return step(state, raw, **kw)

    worker.train_step = requesting_step
    worker.run()
    saved = torch.load(os.path.join(logs, "checkpoint", "train_state.pt"),
                       weights_only=True)
    check(calls[0] == 3 and saved["epoch"] == 1 and saved["step"] == 3,
          f"preemption inside step 3: the loop stopped after {calls[0]} "
          f"steps, the checkpoint resumes at epoch {saved['epoch']} (step "
          f"count {saved['step']})")
    resumed = Worker(cfg.replace(resume_weight_path=os.path.join(
        logs, "checkpoint")), run_dir=tempfile.mkdtemp(dir=root), device=dev)
    same_vars, same_adam = same_state(worker, resumed)
    check(resumed.start_epoch == 1 and same_vars and same_adam,
          f"the resumed Worker restarts epoch {resumed.start_epoch} from the "
          "preempted state, bit-equal")
    del worker
    best = resumed.run()
    check(resumed.state.step == 4 and np.isfinite(best),
          f"the resumed Worker ran epoch 1 to its end: schedule count "
          f"{resumed.state.step}, validation MPJPE {best:.4f} mm")
    del resumed
    torch.cuda.empty_cache()
    return {"stopped_after_steps": calls[0], "checkpoint_epoch":
            saved["epoch"], "resumed_val_mpjpe_mm": best}


# ---------------------------------------------------------------------------
# image decode: the RHD PNG tree, its cache, the Evaluator on both


def decode_phase(dev, root, written):
    """The cache built from the tree's PNGs (timed) holds exactly the
    pixels the writer was given; the PNG pair decode rate at
    ``num_workers`` threads; a smooth 512x334 JPEG decodes within JPEG
    quantisation of its source; five Evaluator passes decoding the PNGs
    per batch against five on the cache, in turns."""
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data import imageio
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer import Evaluator

    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_name="RHD", dataset_root_dir=root,
                 infer_batch_size=BATCH)
    threads, S = cfg.num_workers, cfg.image_size[0]
    t0 = time.perf_counter()
    ds = RHDDataset(root, "evaluation", threads, S, cache_decoded=True)
    cache_s = time.perf_counter() - t0
    d = os.path.join(root, "evaluation")
    same = all(
        np.array_equal(ds._color_mm[i],
                       written[os.path.join(d, "color", f"{i:05d}.png")])
        and np.array_equal(ds._mask_mm[i],
                           written[os.path.join(d, "mask", f"{i:05d}.png")])
        for i in range(N_SAMPLES))
    check(same, f"the decoded cache of {N_SAMPLES} PNG pairs equals the "
          "written pixels exactly")
    cpaths = [os.path.join(d, "color", f"{i:05d}.png")
              for i in range(N_SAMPLES)]
    mpaths = [p.replace("color", "mask") for p in cpaths]
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        imageio.decode_batch(cpaths, S, S, 3, threads)
        imageio.decode_batch(mpaths, S, S, 1, threads)
        rates.append(N_SAMPLES / (time.perf_counter() - t0))

    # a smooth frame through the port's JPEG writer and decoder
    y, x = np.mgrid[0:512, 0:334]
    smooth = np.stack([127 + 100 * np.sin(x / 37.0 + c) * np.cos(y / 53.0 - c)
                       for c in range(3)], -1).astype(np.uint8)
    jpg = os.path.join(root, "smooth.jpg")
    imageio.write_jpeg(jpg, smooth)
    back = imageio.decode_batch([jpg], 512, 334)[0]
    mse = float(((back.astype(np.float64) - smooth) ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    check(psnr >= 40.0, f"a smooth 512x334 frame through the JPEG writer "
          f"(quality 95, 4:2:0) and decoder: PSNR {psnr:.2f} dB >= 40")

    ev_png = Evaluator(cfg, device=dev)
    ev_cache = Evaluator(cfg.replace(cache_decoded=True), device=dev)
    for ev in (ev_png, ev_cache):
        ev.evaluate(max_batches=1)
    passes = {"png": [], "cache": []}
    results = {"png": [], "cache": []}
    for _ in range(5):
        for name, ev in (("png", ev_png), ("cache", ev_cache)):
            t0 = time.perf_counter()
            results[name].append(ev.evaluate())
            torch.cuda.synchronize()
            passes[name].append(N_SAMPLES / (time.perf_counter() - t0))
    check(len(set(results["png"] + results["cache"])) == 1,
          f"Evaluator MPJPE from PNGs == from the cache, every pass: "
          f"{results['png'][0]!r} mm")
    out = {"cache_build_s": cache_s,
           "cache_build_img_per_s": N_SAMPLES / cache_s,
           "png_pair_decode_img_per_s": rates, "decode_threads": threads,
           "smooth_jpeg_psnr_db": psnr,
           "evaluator_img_per_s_png": passes["png"],
           "evaluator_img_per_s_cache": passes["cache"]}
    print(f"decode: cache of {N_SAMPLES} PNG pairs in {cache_s:.3f} s, PNG "
          f"pairs {max(rates):.1f} img/s at {threads} threads; Evaluator "
          f"from PNGs {np.median(passes['png']):.1f} img/s, from the cache "
          f"{np.median(passes['cache']):.1f} img/s (medians of 5)",
          flush=True)
    del ev_png, ev_cache
    return out


# ---------------------------------------------------------------------------
# InterHand2.6M: serving and training


# (H, W) of the synthetic frames: InterHand's 512x334 portrait captures
# and one in four landscape, so pad_to="auto" pads every frame
IH_SIZES = [(512, 334), (512, 334), (512, 334), (334, 512)]


def interhand_config(root, **kw):
    from handpose_tpu_torch import Config
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  dataset_name="InterHand2.6M", dataset_root_dir=root,
                  batch_size=BATCH, infer_batch_size=BATCH, **kw)


def interhand_serving_phase(dev, root):
    """The val split's cache (timed) and its JPEG decode rate; K1 on the
    InterHand coordinates against its plain version; the Evaluator's
    evaluate_full (one K1 launch a batch, finite MPJPE, a PCK curve that
    never falls) and serve; the card against the host, float32; the
    device-resident b256 serving rate and its layers; five Evaluator
    passes decoding the JPEGs against five on the cache."""
    from handpose_tpu_torch.data import imageio
    from handpose_tpu_torch.data.interhand import InterHandDataset
    from handpose_tpu_torch.data.preprocess import preprocess_interhand_batch
    from handpose_tpu_torch.infer import (Evaluator, load_serving_model,
                                          serve)
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.ops import heatmap, scoremap_cuda

    cfg = interhand_config(root, cache_decoded=True)
    threads = cfg.num_workers
    t0 = time.perf_counter()
    ds = InterHandDataset(root, cfg.interhand_eval_split, cfg.fast_trainval,
                          cfg.trans_test, cfg.input_img_shape, threads,
                          pad_to="auto", cache_decoded=True)
    cache_s = time.perf_counter() - t0
    pad = tuple(max(hw[k] for hw in IH_SIZES) for k in (0, 1))
    check(ds.pad_to == pad and len(ds) == N_SAMPLES,
          f"InterHand val split: {len(ds)} frames of {sorted(set(IH_SIZES))}"
          f" padded to {ds.pad_to}")
    paths = [e["img_path"] for e in ds.datalist]
    hw = [(e["height"], e["width"]) for e in ds.datalist]
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        imageio.decode_padded(paths, hw, ds.pad_to, threads)
        rates.append(N_SAMPLES / (time.perf_counter() - t0))
    raw_host = ds.raw_batch(range(BATCH))
    raw = raw_host.to(dev)
    pp = serving_kwargs(cfg)
    crop, sigma = cfg.crop_size, cfg.sigma

    # K1 on the InterHand path's coordinates, plain and with uv noise
    kernel, plain = scoremap_cuda.render_gaussian_maps_cuda, \
        heatmap.render_gaussian_maps
    g = torch.Generator(device=dev).manual_seed(13)
    max_err = 0.0
    with torch.inference_mode():
        for name, kw in (("serving", {}),
                         ("uv noise", {"coord_uv_noise": True,
                                       "generator": g})):
            s = preprocess_interhand_batch(raw, crop_size=crop, sigma=sigma,
                                           switch_joint_order=False, **kw)
            c = torch.stack([s["keypoint_uv21"][..., 1],
                             s["keypoint_uv21"][..., 0]], -1).contiguous()
            v = s["keypoint_vis21"].contiguous()
            del s
            err = float((kernel(c, (crop, crop), sigma, v)
                         - plain(c, (crop, crop), sigma, v)).abs().max())
            max_err = max(max_err, err)
            check(err <= 1e-6, f"scoremap kernel == plain on the InterHand "
                  f"{name} coordinates: max |diff| {err:.3g} <= 1e-6")

    ev = Evaluator(cfg, device=dev)
    server = load_serving_model(cfg, device=dev)
    ev.evaluate_full(max_batches=1)
    torch.cuda.synchronize()
    # ---- the main path, with the launch count read around it ----
    k1 = scoremap_cuda.KERNEL
    k1.launches = 0
    full = ev.evaluate_full()
    torch.cuda.synchronize()
    eval_launches = k1.launches
    xyz, uv = serve(server, raw, cfg, device=dev)
    torch.cuda.synchronize()
    launches = k1.launches
    n_batches = -(-N_SAMPLES // BATCH)
    check(eval_launches == n_batches and launches == n_batches + 1,
          f"InterHand: scoremap launched once per Evaluator batch "
          f"({eval_launches} for {n_batches}) and once by serve")
    curve = np.asarray(full["pck"])
    check(np.isfinite(full["mpjpe"]) and full["mpjpe"] > 0
          and bool(np.all(np.diff(curve) >= 0)) and 0 <= curve[0]
          and curve[-1] <= 1,
          f"InterHand evaluate_full: MPJPE {full['mpjpe']:.4f} mm, PCK "
          f"{curve[0]:.4f} at 20 mm to {curve[-1]:.4f} at 50 mm, never "
          f"falling, AUC {full['auc_20_50mm']:.4f}")
    check(tuple(xyz.shape) == (BATCH, 21, 3)
          and bool(torch.isfinite(xyz).all() and torch.isfinite(uv).all()),
          "InterHand serve: finite (B, 21, 3) and (B, 21, 2)")

    cfg32 = cfg.replace(compute_dtype="float32")
    small = ds.raw_batch(range(4))
    host = serve(load_serving_model(cfg32, device="cpu"), small, cfg32,
                 device="cpu")
    card = serve(load_serving_model(cfg32, device=dev), small, cfg32,
                 device=dev)
    errs = [rel_err(a, b) for a, b in zip(host, card)]
    check(max(errs) <= F32_RTOL,
          f"InterHand card vs host path, f32, b4: xyz {errs[0]:.3g}, uv "
          f"{errs[1]:.3g} of range <= {F32_RTOL}")

    with torch.inference_mode():
        serve_ms = cuda_ms(lambda: serve(server, raw, cfg, dev), 5)
        preprocess_ms = cuda_ms(
            lambda: preprocess_interhand_batch(raw, **pp), 5)
    ev_jpeg = Evaluator(cfg.replace(cache_decoded=False), device=dev)
    ev_jpeg.evaluate(max_batches=1)
    passes = {"jpeg": [], "cache": []}
    for _ in range(5):
        for name, e in (("jpeg", ev_jpeg), ("cache", ev)):
            t0 = time.perf_counter()
            e.evaluate()
            torch.cuda.synchronize()
            passes[name].append(N_SAMPLES / (time.perf_counter() - t0))
    out = {"cache_build_s": cache_s, "jpeg_decode_img_per_s": rates,
           "decode_threads": threads, "frame_hw": IH_SIZES,
           "pad_to": list(ds.pad_to),
           "mpjpe_mm": full["mpjpe"], "pck": curve.tolist(),
           "auc_20_50mm": full["auc_20_50mm"],
           "serve_img_per_s_b256_device_resident": BATCH / serve_ms * 1e3,
           "serve_ms": serve_ms, "preprocess_ms": preprocess_ms,
           "forward_ms": serve_ms - preprocess_ms,
           "evaluator_img_per_s_jpeg": passes["jpeg"],
           "evaluator_img_per_s_cache": passes["cache"],
           "scoremap_max_abs_err": max_err}
    print(f"InterHand serving b{BATCH}: {BATCH / serve_ms * 1e3:.1f} img/s "
          f"device resident (preprocess {preprocess_ms:.3f} ms of "
          f"{serve_ms:.3f}); JPEG {max(rates):.1f} img/s at {threads} "
          f"threads; Evaluator from JPEGs "
          f"{np.median(passes['jpeg']):.1f} img/s, from the cache "
          f"{np.median(passes['cache']):.1f} img/s", flush=True)
    del ev, ev_jpeg, server
    torch.cuda.empty_cache()
    return out, launches, max_err


def interhand_training_phase(dev, root):
    """The InterHand Worker at b256 with both of its augmentations, two
    epochs through the decoded cache: launch counts, finite losses, the
    dropout's keep share; the Evaluator on model_best equals the run's
    best; the step's layer times and peak memory."""
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.infer import Evaluator
    from handpose_tpu_torch.train import Worker

    logs = tempfile.mkdtemp(dir=root)
    cfg = interhand_config(root, max_epoch=2, save_log_dir=logs,
                           cache_decoded=True, coord_uv_noise=True,
                           scoremap_dropout=True)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    stats = {"keep": zero.clone(), "elements": zero.clone()}
    draw = pp_mod.draw_augmentations

    def counting_draw(flags, shapes, generator):
        d = draw(flags, shapes, generator)
        stats["keep"] += d.dropout_keep.sum()
        stats["elements"] += d.dropout_keep.numel()
        return d

    worker = Worker(cfg, run_dir=logs, device=dev)
    check(sorted(f for f, on in worker.aug_flags.items() if on)
          == ["coord_uv_noise", "scoremap_dropout"],
          "InterHand Worker: the two InterHand augmentations on")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(pp_mod, "draw_augmentations", counting_draw):
        best = worker.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = worker.state.step
    check(steps == 4, f"InterHand Worker took {steps} train steps over 2 "
          "epochs")
    launches = check_worker_launches(worker, "InterHand Worker run")
    losses = epoch_losses(worker)
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"InterHand Worker: finite epoch training losses {losses}")
    keep = float(stats["keep"] / stats["elements"])
    check(abs(keep - 0.2) <= 1e-3, f"InterHand dropout keep share "
          f"{keep:.6f} = 0.2 +- 0.001 ({int(stats['elements'])} elements)")
    ev_mpjpe = Evaluator(cfg, weights=os.path.join(logs, "model_best"),
                         device=dev).evaluate()
    check(np.isfinite(best) and ev_mpjpe == best,
          f"InterHand Evaluator on model_best: {ev_mpjpe!r} mm == the "
          f"Worker's best validation MPJPE {best!r}")
    raw = worker.train_ds.raw_batch(range(BATCH)).to(dev)
    split = step_split(worker, raw)
    med = float(np.median(worker.stats.train_seconds[1:]))
    out = {"steps": steps, "epoch_losses": losses, "val_mpjpe_mm": best,
           "evaluator_model_best_mpjpe_mm": ev_mpjpe, "run_s": t_run,
           "step_s": worker.stats.train_seconds,
           "median_step_ms_after_first": med * 1e3,
           "train_img_per_s_median_after_first": BATCH / med, **split,
           "max_memory_allocated_bytes": peak,
           "launches": dict(zip(("scoremap", "moments", "pool_bwd"),
                                launches)),
           "dropout_keep_share": keep}
    print(f"InterHand training b{BATCH}: median step {med * 1e3:.1f} ms "
          f"after the first, step {split['step_ms']:.3f} ms = preprocess "
          f"{split['preprocess_ms']:.3f} + forward {split['forward_ms']:.3f}"
          f" + backward and Adam {split['backward_and_update_ms']:.3f}; "
          f"validation MPJPE {best:.4f} mm; peak {peak} B", flush=True)
    del worker
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# the one-trunk models (the ResNet-50, FK and MANO families): serving,
# the Evaluator and training through the Worker, the three stems


def model_config(root, model="Hand3DPoseNet", logs="logs", **kw):
    """A model of the ResNet-50, FK or MANO families at full width on the
    RHD tree: crop 256, its CLI's default input channels (3, the image
    crop; 24, image and scoremaps, for ThreeHandShapeAndPoseMANO and
    Resnet50MANO3DHandPose), resnet_out_feature_dim 1024, bf16 compute,
    f32 params, bn_variance 'fast', mano_pose_num 10, the synthetic MANO
    stand-in, b256, two epochs of two steps (the tree's one split trains
    and validates)."""
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.config import default_input_channels
    kw = {"max_epoch": 2, **kw}
    return Config(model_name=model,
                  input_channels=default_input_channels(model),
                  dataset_name="RHD", dataset_root_dir=root,
                  batch_size=BATCH, infer_batch_size=BATCH,
                  use_val_dataset_to_debug=True, save_log_dir=logs,
                  cache_decoded=True, **kw)


def trunk_of(model):
    """The convolutional trunk of a model of one trunk (its input is
    NCHW): a ResNet or ``ResNetMano``."""
    from handpose_tpu_torch.nn import ResNet, ResNetMano
    return next(m for m in model.modules()
                if isinstance(m, (ResNet, ResNetMano)))


def _flat_tensors(d):
    return [t for v in d.values()
            for t in (v if isinstance(v, tuple) else (v,))]


def card_vs_host_geometry(dev, root, model):
    """An FK or MANO model's serving path (preprocessing, the inference
    build's forward), float32, TF32 off, b4 at crop 64, on the card and
    the host: the geometry's inputs to 1e-4 of range, then the card's
    outputs computed from the host's geometry inputs to 1e-4 of range.
    Random heads give FK and MANO angles of hundreds of radians and
    joints near the projection's pole, where the geometry multiplies
    float32 rounding in its inputs by up to ~1e3, so the two parts are
    held apart."""
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer import load_serving_model, serve
    from handpose_tpu_torch.models import hook_geometry_inputs
    cfg = model_config(root, model, compute_dtype="float32",
                       input_img_shape=(64, 64))
    small = RHDDataset(root, "evaluation",
                       cache_decoded=True).raw_batch(range(4))
    host_model = load_serving_model(cfg, device="cpu")
    host_in = hook_geometry_inputs(host_model)
    host = serve(host_model, small, cfg, device="cpu")
    card_model = load_serving_model(cfg, device=dev)
    card_in = hook_geometry_inputs(card_model)
    serve(card_model, small, cfg, device=dev)
    in_err = max(rel_err(h, c) for h, c in zip(_flat_tensors(host_in),
                                               _flat_tensors(card_in)))
    given = load_serving_model(cfg, device=dev)
    hook_geometry_inputs(given, host_in)
    card = serve(given, small, cfg, device=dev)
    errs = [rel_err(h, c) for h, c in zip(host, card) if h is not None]
    check(in_err <= F32_RTOL and max(errs) <= F32_RTOL,
          f"{model} card vs host path, f32, b4 crop 64: geometry inputs "
          f"{in_err:.3g}, outputs from the host's geometry inputs "
          f"{max(errs):.3g} of range <= {F32_RTOL}")
    return {"geometry_inputs": in_err, "outputs": errs}


def _to(v, device, dtype):
    """``v``'s tensors (also in tuples and dicts) on ``device``, the
    floating ones cast to ``dtype``."""
    if torch.is_tensor(v):
        return v.to(device, dtype) if v.is_floating_point() else v.to(device)
    if isinstance(v, dict):
        return {k: _to(x, device, dtype) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to(x, device, dtype) for x in v)
    return v


def card_vs_host_sampler(dev, host, card, run, what):
    """A sampler on the card against the host, in two parts, so that the
    rounding its steps amplify does not decide the check (a float32
    sample's distance from float64 varies 1x-4x from one x_T to the next,
    PERF.md §6).  ``host``/``card``: a float32 module holding the
    ``Unet1D`` on each device; ``run(module, device, dtype)``: the
    sampler's output on it, from injected draws.

    1. The whole sampler in float64 (weights, time embedding, schedule,
       loop, clip), card vs host <= 1e-9 of range: the card runs the
       host's arithmetic, step for step.
    2. Each denoiser call of the host's float64 run, replayed in float32
       from its float64 inputs on both devices: card vs host within twice
       the host's own float32-vs-float64 distance on that call plus 1e-5
       of range (the Unet1D tolerance).

    Returns the numbers and the float64 samples."""
    import copy
    from handpose_tpu_torch.nn.diffusion import Unet1D
    unet_of = lambda m: next(u for u in m.modules() if isinstance(u, Unet1D))
    leaves = lambda v: list(v.values()) if isinstance(v, dict) else [v]
    host64, card64 = copy.deepcopy(host).double(), copy.deepcopy(card).double()
    calls = []
    hook = unet_of(host64).register_forward_hook(
        lambda m, args, kwargs, out: calls.append((args, kwargs, out)),
        with_kwargs=True)
    with torch.no_grad():
        h64 = run(host64, "cpu", torch.float64)
        hook.remove()
        c64 = run(card64, dev, torch.float64)
    del host64, card64
    f64_err = rel_err(h64, c64)
    errs, excess = [], []
    hu, cu = unet_of(host), unet_of(card)
    f32 = torch.float32
    with torch.no_grad():
        for args, kwargs, out in calls:
            h32 = hu(*_to(args, "cpu", f32), **_to(kwargs, "cpu", f32))
            c32 = cu(*_to(args, dev, f32), **_to(kwargs, dev, f32))
            for o, h, c in zip(leaves(out), leaves(h32), leaves(c32)):
                errs.append(rel_err(h, c))
                excess.append(errs[-1] - 2 * rel_err(o, h) - 1e-5)
    check(f64_err <= 1e-9 and max(excess) <= 0,
          f"{what} card vs host: float64 sample {f64_err:.3g} of range <= "
          f"1e-9; the {len(calls)} denoiser calls of the host's float64 "
          f"run in float32, worst {max(errs):.3g}, each <= 2 x the host's "
          f"f32-vs-f64 on the call + 1e-5 (worst margin {-max(excess):.3g})")
    return {"float64_sample": f64_err, "float32_calls": len(calls),
            "float32_call_max": max(errs),
            "float32_call_min_margin": -max(excess)}, h64, c64


def card_vs_host_diffusion(dev, root):
    """DiffusionHandPose's serving path, float32, TF32 off, b4 at crop 64,
    the full T = 400 / S = 200 ladder ('auto' hoists at b4), on the card
    and the host from one injected x_T, in parts held apart where
    rounding is amplified: the trunk's features (the sampler's
    condition) to 1e-4 of range; the sampler on the host's features by
    :func:`card_vs_host_sampler` (the free-running float32 samples'
    distance, and each device's from float64, reported); then, with the
    host's sample given to the card, the bone heads' outputs (FK's
    inputs) to 1e-4; then the outputs from the host's bone-head outputs
    to 1e-4 (FK multiplies rounding in its inputs, as in
    :func:`card_vs_host_geometry`)."""
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer import load_serving_model, serve
    from handpose_tpu_torch.models import hook_geometry_inputs
    cfg = model_config(root, DIFFUSION, compute_dtype="float32",
                       input_img_shape=(64, 64))
    small = RHDDataset(root, "evaluation",
                       cache_decoded=True).raw_batch(range(4))
    x_T = torch.randn(4, 1, 63, generator=torch.Generator().manual_seed(7))

    @contextlib.contextmanager
    def pinned(model, device, cond=None, given=None):
        """The model's sampler from x_T, on ``cond`` in place of its own
        condition (or returning ``given``); yields the lists its
        conditions and samples go to."""
        sample, conds, seen = model.diff_model.sample, [], []

        def fn(own, generator=None, **kw):
            conds.append(own)
            c = own if cond is None else cond.to(device)
            out = (sample(c, init_noise=x_T.to(device)) if given is None
                   else given.to(device))
            seen.append(out)
            return out

        with mock.patch.object(model.diff_model, "sample", fn):
            yield conds, seen

    host_model = load_serving_model(cfg, device="cpu")
    host_in = hook_geometry_inputs(host_model)
    with pinned(host_model, "cpu") as (host_conds, host_samples):
        host = serve(host_model, small, cfg, device="cpu")
    host_feat, host_sample = host_conds[0], host_samples[0]
    card_model = load_serving_model(cfg, device=dev)
    with pinned(card_model, dev, cond=host_feat) as (card_feat, card_sample):
        serve(card_model, small, cfg, device=dev)
    feat_err = rel_err(host_feat, card_feat[0])
    sampler, h64, c64 = card_vs_host_sampler(
        dev, host_model.diff_model, card_model.diff_model,
        lambda m, d, dt: m.sample(host_feat.to(d, dt),
                                  init_noise=x_T.to(d, dt)),
        f"{DIFFUSION} sampler, T 400 / S 200, b4")
    sampler.update({"float32_sample": rel_err(host_sample, card_sample[0]),
                    "host_float32_vs_float64": rel_err(h64, host_sample),
                    "card_float32_vs_float64": rel_err(c64, card_sample[0])})
    del card_model
    given = load_serving_model(cfg, device=dev)
    card_in = hook_geometry_inputs(given, host_in)
    with pinned(given, dev, given=host_sample):
        card = serve(given, small, cfg, device=dev)
    in_err = max(rel_err(h, c) for h, c in zip(_flat_tensors(host_in),
                                               _flat_tensors(card_in)))
    errs = [rel_err(h, c) for h, c in zip(host, card)]
    check(feat_err <= F32_RTOL and in_err <= F32_RTOL
          and max(errs) <= F32_RTOL,
          f"{DIFFUSION} card vs host path, f32, b4 crop 64: features "
          f"{feat_err:.3g}, bone heads on the host's sample {in_err:.3g}, "
          f"outputs from the host's bone heads {max(errs):.3g} of range "
          f"<= {F32_RTOL}; free-running f32 samples "
          f"{sampler['float32_sample']:.3g} apart (f32 vs f64: host "
          f"{sampler['host_float32_vs_float64']:.3g}, card "
          f"{sampler['card_float32_vs_float64']:.3g})")
    return {"features": feat_err, "sampler": sampler,
            "geometry_inputs": in_err, "outputs": errs}


def model_serving_phase(dev, root, raw_host, model="Hand3DPoseNet"):
    """A model's serving path: the Evaluator over the split (one K1 launch
    a batch) and serve on one batch, device resident; the card against
    the host on a small float32 batch (for the FK and MANO models in two
    parts, :func:`card_vs_host_geometry`; a model with a sampler,
    DiffusionHandPose, in three, :func:`card_vs_host_diffusion`); the
    layers' times (for a sampler's model, whose forward runs 200 denoise
    steps of host-paced launches, serve is the main path's call and the
    forward is serve less preprocessing)."""
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer import (Evaluator, load_serving_model,
                                          serve)
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.ops import scoremap_cuda

    cfg = model_config(root, model)
    check(cfg.crop_size == 256 and cfg.compute_dtype == "bfloat16"
          and cfg.resnet_out_feature_dim == 1024 and cfg.resnet_stem == "k3s2"
          and cfg.mano_pose_num == 10 and cfg.condition_feat_dim == 256
          and (cfg.num_timesteps, cfg.num_sampling_timesteps) == (400, 200),
          f"{model} at full width: crop 256, {cfg.input_channels} channels, "
          "1024-d features, bf16 compute, k3s2 stem, MANO pose_num 10; "
          "diffusion: 256-d condition, T 400, DDIM 200")
    raw = raw_host.to(dev)
    ev = Evaluator(cfg, device=dev)
    server = load_serving_model(cfg, device=dev)
    # a sampler's pass is seconds of host work: no warm call (the
    # diffusion phase ran its shapes), and serve timed on the main path
    sampler = getattr(server, "stochastic", False)
    if not sampler:
        ev.evaluate(max_batches=1)                   # warm: cuDNN, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1 = scoremap_cuda.KERNEL
    # ---- the main path, with the launch count read around it ----
    k1.launches = 0
    t0 = time.perf_counter()
    mpjpe = ev.evaluate()
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    eval_launches = k1.launches
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    xyz, uv = serve(server, raw, cfg, device=dev)
    end.record()
    end.synchronize()
    served_ms = start.elapsed_time(end)
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-N_SAMPLES // BATCH)
    check(eval_launches == n_batches and launches == n_batches + 1,
          f"{model}: scoremap launched once per Evaluator batch "
          f"({eval_launches} for {n_batches}) and once by serve")
    check(np.isfinite(mpjpe) and mpjpe > 0,
          f"{model} whole-split MPJPE finite: {mpjpe:.4f} mm")
    # ThreeHandShapeAndPoseMANO has no uv without network_regress_uv
    check(tuple(xyz.shape) == (BATCH, 21, 3)
          and bool(torch.isfinite(xyz).all())
          and (uv is None or (tuple(uv.shape) == (BATCH, 21, 2)
                              and bool(torch.isfinite(uv).all()))),
          f"{model} serve: finite (B, 21, 3) xyz"
          + (", no uv" if uv is None else " and (B, 21, 2) uv"))

    if model in FK_MANO_MODELS:
        errs = card_vs_host_geometry(dev, root, model)
    elif sampler:
        errs = card_vs_host_diffusion(dev, root)
    else:
        cfg32 = cfg.replace(compute_dtype="float32")
        small = RHDDataset(root, "evaluation",
                           cache_decoded=True).raw_batch(range(4))
        host = serve(load_serving_model(cfg32, device="cpu"), small, cfg32,
                     device="cpu")
        card = serve(load_serving_model(cfg32, device=dev), small, cfg32,
                     device=dev)
        errs = [rel_err(a, b) for a, b in zip(host, card)]
        check(max(errs) <= F32_RTOL,
              f"{model} card vs host path, f32, b4: xyz {errs[0]:.3g}, uv "
              f"{errs[1]:.3g} of range <= {F32_RTOL}")

    with torch.inference_mode():
        sample = preprocess_batch(raw, **serving_kwargs(cfg))
        inp = model_input(sample, cfg.input_channels)
        x = inp.permute(0, 3, 1, 2).to(dtype=torch.bfloat16,
                                       memory_format=torch.channels_last)
        K, sc, rt = (sample["camera_intrinsic_matrix"],
                     sample["keypoint_scale"], sample["keypoint_xyz_root"])
        trunk = trunk_of(server)
        layers = {
            "preprocess_ms": cuda_ms(
                lambda: preprocess_batch(raw, **serving_kwargs(cfg)), 5),
            "trunk_ms": cuda_ms(lambda: trunk(x), 5)}
        if sampler:            # the main path's serve call, timed above
            layers["serve_ms"] = served_ms
            layers["forward_ms"] = served_ms - layers["preprocess_ms"]
        else:
            layers["serve_ms"] = cuda_ms(lambda: serve(server, raw, cfg,
                                                       dev), 5)
            layers["forward_ms"] = cuda_ms(lambda: server(inp, K, sc, rt),
                                           5)
        del sample, inp, x
    out = {"model": model, "input_channels": cfg.input_channels,
           "mpjpe_mm": mpjpe, "evaluator_img_per_s": N_SAMPLES / t_eval,
           "serve_img_per_s_b256_device_resident":
               BATCH / layers["serve_ms"] * 1e3,
           "max_memory_allocated_bytes": peak, "card_vs_host_rel": errs,
           **layers}
    print(f"{model} serving b{BATCH}: "
          f"{out['serve_img_per_s_b256_device_resident']:.1f} img/s device "
          f"resident (serve {layers['serve_ms']:.3f} ms = preprocess "
          f"{layers['preprocess_ms']:.3f} + forward {layers['forward_ms']:.3f}"
          f", trunk {layers['trunk_ms']:.3f}); Evaluator "
          f"{out['evaluator_img_per_s']:.1f} img/s; peak {peak} B",
          flush=True)
    del ev, server
    torch.cuda.empty_cache()
    return out, launches


def model_training_phase(dev, root, raw_host, model, max_epoch=2):
    """The Worker of a model at b256, ``max_epoch`` epochs of two steps
    with validation: launch counts (K1 a step or batch; K2 53 a step at
    the 12 ResNet-50 shapes, or 36 at the flagship's 5 for ResNetMano; K3
    once a step, tiled), finite losses with exactly the terms of the
    model's gates (``loss_uv`` in pixels, over 1e5 in the total), the
    Evaluator on model_best equal to the run's best, the step's layer
    times and peak memory."""
    from handpose_tpu_torch.config import LOSS_GATES
    from handpose_tpu_torch.infer import Evaluator
    from handpose_tpu_torch.nn import ResNetMano
    from handpose_tpu_torch.train import Worker

    logs = tempfile.mkdtemp(dir=root)
    cfg = model_config(root, model, logs, max_epoch=max_epoch)
    worker = Worker(cfg, run_dir=logs, device=dev)
    bn_shapes = (BN_MANO_SHAPES
                 if isinstance(trunk_of(worker.model), ResNetMano)
                 else BN50_SHAPES)
    # whether the model gives a uv, which the uv and hand-mask terms need
    has_uv = []
    worker.model.register_forward_hook(
        lambda module, args, out: has_uv.append(out.uv is not None))
    step = worker.train_step
    step_losses = []

    def recording_step(state, raw, **kw):
        state, losses = step(state, raw, **kw)
        step_losses.append({k: float(v) for k, v in losses.items()})
        return state, losses

    worker.train_step = recording_step
    # a sampler's passes in the training steps, timed where they run:
    # (start, end, sample)
    passes, timed = [], contextlib.nullcontext()
    if getattr(worker.model, "stochastic", False):
        sample = worker.model.diff_model.sample

        def timed_sample(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = sample(*args, **kw)
            end.record()
            if worker.model.training:
                passes.append((start, end, out))
            return out

        timed = mock.patch.object(worker.model.diff_model, "sample",
                                  timed_sample)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with timed:
        best = worker.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    k2_shapes = dict(_counts()[1].by_shape)
    steps = worker.state.step
    check(steps == 2 * max_epoch, f"{model} Worker took {steps} train steps "
          f"over {max_epoch} epochs")
    launches = check_worker_launches(worker, f"{model} Worker run",
                                     bn_shapes, trunks=1)
    losses = epoch_losses(worker)
    check(len(losses) == max_epoch and all(np.isfinite(losses)) and all(
        np.isfinite(v) for d in step_losses for v in d.values()),
        f"{model} Worker: finite losses, epochs {losses}")
    check(len(set(has_uv)) == 1, f"{model}: a uv on every call or none")
    terms = {f"loss_{g}" for g, on in LOSS_GATES[model].items() if on
             and (has_uv[0] or g not in ("uv", "hand_mask"))}
    parts = [{k: v / (1e5 if k == "loss_uv" else 1.0)
              for k, v in d.items() if k != "loss"} for d in step_losses]
    ok = all(set(p) == terms and abs(d["loss"] - sum(p.values()))
             <= 1e-5 * sum(abs(v) for v in p.values())
             for d, p in zip(step_losses, parts))
    check(ok, f"{model}: the loss terms of its gates {sorted(terms)}, "
          f"loss_uv over 1e5 in the total ({step_losses[0]})")
    ev_mpjpe = Evaluator(cfg, weights=os.path.join(logs, "model_best"),
                         device=dev).evaluate()
    check(np.isfinite(best) and ev_mpjpe == best,
          f"{model} Evaluator on model_best: {ev_mpjpe!r} == the Worker's "
          f"best validation MPJPE {best!r}")
    worker.train_step = step
    pass_ms = [start.elapsed_time(end) for start, end, _ in passes]
    split = step_split(worker, raw_host.to(dev), (pass_ms[-1], passes[-1][2])
                       if passes else None)
    if passes:
        split["sampler_ms_by_step"] = pass_ms
    med = float(np.median(worker.stats.train_seconds[1:]))
    out = {"model": model, "input_channels": cfg.input_channels,
           "steps": steps, "epoch_losses": losses,
           "step_losses": step_losses, "val_mpjpe": best,
           "evaluator_model_best_mpjpe": ev_mpjpe, "run_s": t_run,
           "step_s": worker.stats.train_seconds,
           "median_step_ms_after_first": med * 1e3,
           "train_img_per_s_median_after_first": BATCH / med, **split,
           "max_memory_allocated_bytes": peak,
           "launches": dict(zip(("scoremap", "moments", "pool_bwd"),
                                launches))}
    sampler = ("" if "sampler_ms" not in split else
               f" (sampler {split['sampler_ms']:.3f})")
    print(f"{model} training b{BATCH}: {BATCH / med:.1f} img/s (median step "
          f"{med * 1e3:.1f} ms after the first), step {split['step_ms']:.3f}"
          f" ms = preprocess {split['preprocess_ms']:.3f} + forward "
          f"{split['forward_ms']:.3f}{sampler} + backward and Adam "
          f"{split['backward_and_update_ms']:.3f}; validation MPJPE "
          f"{best:.4f}; peak {peak} B", flush=True)
    del worker
    torch.cuda.empty_cache()
    return out, launches, k2_shapes


def fk_mano_phase(dev):
    """FK on the card against ``tests/fixtures/fk.npz`` (the torch
    reference's outputs) at both joint orders, at the JAX test's
    tolerances; the MANO layer on the synthetic stand-in at b256 on the
    card against the host's plain float32 run, 1e-5 of range, for
    pose_num 6, 10 and 45; ``rodrigues`` near and at a zero rotation,
    card vs host, and which branch the card takes; ``hand_mask_loss`` on
    uv out of int32's range or not finite: one value on the card and the
    host."""
    from handpose_tpu_torch.losses import hand_mask_loss
    from handpose_tpu_torch.nn import fk, mano
    from handpose_tpu_torch.ops.rotations import rodrigues

    path = mano.find_mano_pkl()
    print(f"MANO used by the FK and MANO phases: "
          f"{path or 'the synthetic stand-in (no MANO_RIGHT.pkl)'}",
          flush=True)
    out = {"mano": path or "synthetic stand-in"}
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "fk.npz")
    with np.load(fixture) as f:
        f = {k: f[k] for k in f.files}
    args = [torch.from_numpy(f[k]).to(dev) for k in (
        "root_angles", "other_angles", "bone_lengths", "K", "scale", "root")]
    for switched in (True, False):
        xyz, uv = fk.forward_kinematics(*args, joint_order_switched=switched)
        key = "noswitch" if switched else "switch"   # the fixture's names
        want_xyz, want_uv = f[f"xyz_{key}"], f[f"uv_{key}"]
        xyz, uv = xyz.cpu().numpy(), uv.cpu().numpy()
        ex = float(np.abs(xyz - want_xyz).max())
        eu = float((np.abs(uv - want_uv) - 1e-4 * np.abs(want_uv)).max())
        check(ex <= 2e-5 and eu <= 5e-2,
              f"FK on the card == fk.npz, joint_order_switched={switched}: "
              f"xyz {ex:.3g} <= 2e-5, uv {eu:.3g} <= 5e-2 + 1e-4 |uv|")
        out[f"fk_switched_{switched}"] = {"xyz_abs_err": ex,
                                          "uv_excess_err": eu}
    g = torch.Generator().manual_seed(3)
    for pose_num in (6, 10, 45):
        inputs = (torch.randn(BATCH, 3, generator=g),
                  torch.randn(BATCH, pose_num, generator=g),
                  torch.randn(BATCH, 10, generator=g) * 0.5)
        inputs[0][0] = 0.0                   # a zero rotation
        layer = mano.ManoLayer(mano.synthetic_mano(), pose_num=pose_num)
        host = layer(*inputs)
        card = layer.to(dev)(*(t.to(dev) for t in inputs))
        errs = [rel_err(h, c) for h, c in zip(host, card)]
        check(card[1].device.type == "cuda" and max(errs) <= 1e-5,
              f"MANO layer b{BATCH} pose_num {pose_num}, card vs host: "
              f"vertices {errs[0]:.3g}, joints {errs[1]:.3g} of range "
              "<= 1e-5")
        out[f"mano_pose_num_{pose_num}"] = errs
    # rodrigues' small-angle test |r|^2 <= 1e-60 (0 in float32) at |r| =
    # 0, 1e-20 (|r|^2 denormal) and 1e-3: which branch the card takes,
    # and the rotation against the host's to 1e-6
    r = torch.tensor([[0.0, 0.0, 0.0], [1e-20, 0.0, 0.0], [6e-4, 8e-4, 0.0]])
    taylor = [bool(t) for t in ((r.to(dev) ** 2).sum(-1) <= 1e-30 * 1e-30)]
    err = float((rodrigues(r.to(dev)).cpu() - rodrigues(r)).abs().max())
    check(err <= 1e-6, f"rodrigues at |r| = 0, 1e-20, 1e-3, card vs host: "
          f"{err:.3g} <= 1e-6; the card takes the Taylor branch at "
          f"{taylor}, the host at "
          f"{[bool(t) for t in ((r ** 2).sum(-1) <= 1e-30 * 1e-30)]}")
    out["rodrigues_taylor_branch_on_card"] = taylor
    odd = np.float32([1e10, -1e10, np.inf, -np.inf, np.nan, 3e9, -3e9,
                      300.7, 12.5, -0.5, 39.99, 63.99, 7.0])
    rng = np.random.default_rng(3)
    mask = torch.from_numpy((rng.uniform(size=(4, 40, 64)) > 0.5).astype(
        np.float32))
    pred = torch.from_numpy(odd[np.arange(4 * 21 * 2).reshape(4, 21, 2)
                                % len(odd)])
    gt = torch.from_numpy(rng.uniform(-5, 70, (4, 21, 2)).astype(np.float32))
    host = float(hand_mask_loss(pred, gt, mask))
    card = float(hand_mask_loss(pred.to(dev), gt.to(dev), mask.to(dev)))
    check(host == card and np.isfinite(host),
          f"hand_mask_loss on uv of +-1e10, +-inf, NaN, +-3e9: card "
          f"{card!r} == host {host!r}")
    out["hand_mask_loss_non_finite_uv"] = host
    return out


def _unet_flops(unet, *args):
    """Multiply-add FLOPs (2 per MAC) of the convolutions and dense layers
    of one ``Unet1D`` call on ``args``, counted from their output shapes
    (the attention products, < 1% at these widths, left out)."""
    from handpose_tpu_torch.nn.diffusion import ConvNd, Linear
    total = []

    def hook(module, inputs, out):
        w = module.weight
        total.append(2 * out.numel() * w[0].numel()
                     if isinstance(module, ConvNd) else
                     2 * out.numel() * w.shape[1])

    handles = [m.register_forward_hook(hook) for m in unet.modules()
               if isinstance(m, (ConvNd, Linear))]
    with torch.no_grad():
        unet(*args)
    for h in handles:
        h.remove()
    return sum(total)


def diffusion_phase(dev, root, raw_host):
    """The sampler of DiffusionHandPose at full width (Unet1D dim 64,
    mults 1/2/4/8, 63-long sequences, 256-d condition, T 400, DDIM S 200,
    eta 0, cosine, pred_noise, clipped x0), float32: the seeded model of
    the main path (``cfg.seed`` 0), conditioned on its bf16 trunk's
    features of the tree's images.  (a) ``Unet1D`` b4 card vs host in the
    plain and time-table modes, 1e-5 of range; (b) a DDPM pass at T 20,
    b4, from an injected x_T and per-step noise, card vs host by
    :func:`card_vs_host_sampler` (the full DDIM ladder is held so on the
    model's path, :func:`card_vs_host_diffusion`); (c) hoist against no
    hoist at b32 on the card, both passes timed once, held to each other
    in float64 to 1e-9 of range; (d) at b256 (no hoist, as 'auto' picks)
    the time of a pass and of a denoise step (CUDA events), the kernels
    launched per denoise step and their device time
    (``torch.profiler``), the device's busy share (that time over the
    unprofiled pass: the profiler slows the host), the convolutions'
    FLOPs against the float32 peak.  A pass is host-bound (~960 launches
    a denoise step), so each is timed from one call."""
    import copy
    from torch.profiler import ProfilerActivity, profile
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.nn.diffusion import GaussianDiffusion1D

    cfg = model_config(root, DIFFUSION)
    net = build_model(cfg).to(dev)
    with torch.no_grad():
        sample = preprocess_batch(raw_host.to(dev), **serving_kwargs(cfg))
        feat = net.features(model_input(sample, cfg.input_channels))
    model = net.diff_model
    del net, sample
    out = {}
    card_unet = model.unet
    unet = copy.deepcopy(card_unet).cpu()
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 63, 1, generator=g)
    t = torch.randint(0, 400, (4,), generator=g)
    c = feat[:4].cpu()
    times = torch.tensor([399.0, 201.0, 0.0])
    with torch.no_grad():
        errs = [rel_err(unet(x, t, c), card_unet(x.to(dev), t.to(dev),
                                                 c.to(dev)))]
        tabs, ctabs = unet(None, times, c), card_unet(None, times.to(dev),
                                                      c.to(dev))
        errs += [rel_err(v, ctabs[k]) for k, v in tabs.items()]
        errs.append(rel_err(
            unet(x, t, c, time_tables={k: v[1] for k, v in tabs.items()}),
            card_unet(x.to(dev), t.to(dev), c.to(dev),
                      time_tables={k: v[1] for k, v in ctabs.items()})))
    check(max(errs) <= 1e-5, f"Unet1D dim 64, b4, card vs host, plain and "
          f"time-table modes: {max(errs):.3g} of range <= 1e-5")
    out["unet_card_vs_host_rel"] = max(errs)

    # ---- (b) DDPM at T 20 from injected draws, card vs host; the full
    # DDIM ladder is held on the model's path (card_vs_host_diffusion)
    gd = GaussianDiffusion1D(63, timesteps=20, sampling_timesteps=20)
    x_T = torch.randn(4, 63, 1, generator=g)
    noise = torch.randn(20, 4, 63, 1, generator=g)
    ddpm = lambda u, d, dt: gd.sample(u, 4, c.to(d, dt),
                                      init_noise=x_T.to(d, dt),
                                      step_noise=noise.to(d, dt))
    out["ddpm_T20"], _, _ = card_vs_host_sampler(
        dev, unet, card_unet, ddpm, "DDPM T 20, b4, injected draws")

    # ---- (c) hoisted vs unhoisted at b32 on the card: both routes timed
    # (one call each, after one UNet call at these shapes), and held to
    # each other in float64, where the routes' other orders of rounding
    # stay far below the check
    gc = torch.Generator(device=dev).manual_seed(12)
    c32 = feat[:32]
    x32 = torch.randn(32, 1, 63, generator=gc, device=dev)
    with torch.no_grad():
        card_unet(x32.transpose(1, 2), torch.zeros(32, dtype=torch.long,
                                                   device=dev), c32)
    samples, b32_ms = {}, {}
    for hoist in (False, True):
        model.sampler_hoist = hoist
        b32_ms[hoist] = cuda_ms(lambda: samples.update({hoist: model.sample(
            c32, init_noise=x32)}), 1, warm=False)
    model64 = copy.deepcopy(model).double()
    f64 = {}
    for hoist in (False, True):
        model64.sampler_hoist = hoist
        f64[hoist] = model64.sample(c32.double(), init_noise=x32.double())
    del model64
    model.sampler_hoist = "auto"
    err = rel_err(f64[False], f64[True])
    check(model.hoists(32) and err <= 1e-9,
          f"hoisted ('auto' at b32) vs unhoisted sampler on the card, "
          f"float64: {err:.3g} of range <= 1e-9")
    out.update({"hoist_vs_no_hoist_b32_float64_rel": err,
                "hoist_vs_no_hoist_b32_float32_rel": rel_err(samples[False],
                                                             samples[True])})

    # ---- (d) the b256 pass, timed with few iterations ----
    c256 = feat
    x256 = torch.randn(BATCH, 1, 63, generator=gc, device=dev)
    check(not model.hoists(BATCH) and model.hoists(32),
          "'auto' hoists at b32 and not at b256")
    flops = 200 * _unet_flops(model.unet, x256.transpose(1, 2),
                              torch.zeros(BATCH, dtype=torch.long,
                                          device=dev), c256)
    # the FLOP count's UNet call ran these shapes: no warm pass
    pass_ms = cuda_ms(lambda: model.sample(c256, init_noise=x256), 1,
                      warm=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        final = model.sample(c256, init_noise=x256)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.count, getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0)))
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n_kernels = sum(n for n, us in kernels if us > 0)
    kernel_ms = sum(us for _, us in kernels) / 1e3
    check(n_kernels > 0 and kernel_ms > 0,
          f"the profiler saw {n_kernels} kernels, {kernel_ms:.3f} ms, in a "
          "b256 sampler pass")
    check(tuple(final.shape) == (BATCH, 1, 63)
          and bool(torch.isfinite(final).all()),
          f"the b{BATCH} sample of the main path's sampler: finite "
          f"(B, 1, 63)")
    out.update({
        "b256_pass_ms": pass_ms, "b256_denoise_step_ms": pass_ms / 200,
        "b256_pass_img_per_s": BATCH / pass_ms * 1e3,
        "b256_kernels_per_denoise_step": n_kernels / 200,
        "b256_profiled_pass_wall_ms": wall_ms,
        "b256_kernel_ms": kernel_ms,
        "b256_device_busy_share": kernel_ms / pass_ms,
        "b256_unet_gflop_per_pass": flops / 1e9,
        "b256_f32_bound_ms": flops / F32_FLOPS * 1e3,
        "b32_hoisted_pass_ms": b32_ms[True],
        "b32_unhoisted_pass_ms": b32_ms[False]})
    print(f"sampler b{BATCH}: {pass_ms:.1f} ms a pass ({pass_ms / 200:.3f} "
          f"ms a denoise step; {n_kernels / 200:.0f} kernels a step, "
          f"{kernel_ms:.1f} ms of kernels: device busy "
          f"{kernel_ms / pass_ms:.1%} of an unprofiled pass, "
          f"{kernel_ms / wall_ms:.1%} of the profiled one); "
          f"{flops / 1e12:.2f} TFLOP a pass, f32 bound "
          f"{flops / F32_FLOPS * 1e3:.1f} ms; b32 hoisted "
          f"{b32_ms[True]:.1f} ms, unhoisted {b32_ms[False]:.1f} ms",
          flush=True)
    del model, feat
    torch.cuda.empty_cache()
    return out


def stems_phase(dev, root, raw_host):
    """The ResNet-50 trunk under k3s2 and k3s2_s2d with the same weights
    agree (f32, TF32 off, 1e-5 of range, b16); each stem's conv and the
    whole trunk timed at b256 in bf16, eval mode; Hand3DPoseNet with the
    k7s2 stem trains one fused step through K1, K2 and K3."""
    from handpose_tpu_torch.data.preprocess import preprocess_batch
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.models.zoo import init_parameters
    from handpose_tpu_torch.nn.resnet import ExtendedResNet50
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)

    g = torch.Generator(device=dev).manual_seed(5)
    cl = torch.channels_last
    x = torch.rand((16, 3, 256, 256), generator=g, device=dev).contiguous(
        memory_format=cl)
    outs = {}
    base = init_parameters(ExtendedResNet50(3), seed=5).state_dict()
    for stem in ("k3s2", "k3s2_s2d"):
        trunk = ExtendedResNet50(3, stem=stem).to(dev).eval()
        trunk.load_state_dict(base)
        with torch.inference_mode():
            outs[stem] = trunk(x)
        del trunk
    err = rel_err(outs["k3s2"], outs["k3s2_s2d"])
    check(err <= 1e-5, f"ResNet-50 trunk, k3s2_s2d == k3s2 with the same "
          f"weights (f32, TF32 off, b16): {err:.3g} of range <= 1e-5")
    del outs, x
    x = torch.rand((BATCH, 3, 256, 256), generator=g, device=dev).to(
        dtype=torch.bfloat16, memory_format=cl)
    times = {}
    for stem in ("k3s2", "k3s2_s2d", "k7s2"):
        trunk = init_parameters(ExtendedResNet50(
            3, dtype=torch.bfloat16, stem=stem), seed=5).to(dev).eval()
        with torch.inference_mode():
            times[stem] = {
                "stem_conv_ms": cuda_ms(lambda: trunk.trunk.conv_init(x), 10),
                "trunk_forward_ms": cuda_ms(lambda: trunk(x), 5)}
        del trunk
    print(f"stems at b{BATCH}, bf16, eval: {times}", flush=True)
    del x

    # ---- the main path of the k7s2 stem: one fused train step ----
    cfg = model_config(root, resnet_stem="k7s2")
    model = build_model(cfg).to(dev)
    state = create_train_state(model, cfg)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 serving_kwargs(cfg))
    raw = raw_host.to(dev)
    reset_counts()
    _, losses = step(state, raw)
    torch.cuda.synchronize()
    k1, k2, k3 = _counts()
    launches = [k1.launches, k2.launches, k3.launches]
    check(launches == [1, 53, 1] and dict(k2.by_shape) == {
        (N, C): n for _, N, C, n in BN50_SHAPES},
        f"k7s2 Hand3DPoseNet step launched K1, K2, K3 {launches} times, "
        "K2 at the 12 held shapes")
    losses = {k: float(v) for k, v in losses.items()}
    check(all(np.isfinite(v) for v in losses.values()),
          f"k7s2 Hand3DPoseNet trained one step: losses {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return {"s2d_vs_k3s2_rel": err, "b256_bf16_eval": times,
            "k7s2_step_losses": losses}, launches


# ---------------------------------------------------------------------------
# serving artifacts: export, the ops library, the inference CLI, profiling

# the loading process of the export phase: torch, numpy and the port's ops
# (which register the scoremap operator), nothing else of the package
_SERVE_ARTIFACT = r"""
import json, statistics, sys, time
import numpy as np
import torch
import handpose_tpu_torch.ops
from handpose_tpu_torch.ops import scoremap_cuda
artifact, inputs, out_path, iters = sys.argv[1:5]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
program = torch.export.load(artifact)
fn = program.module()
load_s = time.perf_counter() - t0
op = torch.ops.handpose_tpu_torch.render_gaussian_maps.default
calls = sum(n.target == op for n in program.graph.nodes)
args = [a.cuda() for a in torch.load(inputs)]
with torch.no_grad():
    scoremap_cuda.KERNEL.launches = 0
    xyz, uv = fn(*args)
    torch.cuda.synchronize()
    launches = scoremap_cuda.KERNEL.launches
    torch.save({"xyz": xyz.cpu(), "uv": uv.cpu()}, out_path)
    for _ in range(3):
        fn(*args)
    ms, host_ms = [], []
    for _ in range(int(iters)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn(*args)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
print(json.dumps({"load_s": load_s, "op_calls": calls, "launches": launches,
                  "ms": ms, "median_ms": statistics.median(ms),
                  "host_median_ms": statistics.median(host_ms),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("handpose_tpu"))}))
"""
SERVE_ITERS = 25


def median_call_ms(fn, iters=SERVE_ITERS, warm=3):
    """(median, the host's median) over ``iters`` calls of ``fn`` after
    ``warm`` calls: each call timed with CUDA events, and the host's time
    to enqueue it (the call's return, before the card finishes)."""
    for _ in range(warm):
        fn()
    ms, host_ms = [], []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms)), float(np.median(host_ms))


def export_phase(dev, root, raw_host):
    """The flagship's fused serving program exported at full width and
    b256 on the card, saved, then loaded and run in a process that
    imports only torch, numpy and the port's ops: one K1 launch a call,
    its (xyz, uv) equal to eager ``serve`` on the same raw batch, its b256
    rate beside eager's; then DiffusionHandPose's forward at b8 on its
    default ladder, held to ``serve``."""
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.data.preprocess import (RawBatch, model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.infer import export, load_serving_model, serve
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.ops import scoremap_cuda

    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_root_dir=root)
    check(cfg.crop_size == 256 and cfg.compute_dtype == "bfloat16"
          and cfg.param_dtype == "float32" and cfg.bn_mode == "fast",
          "export at full width: crop 256, 21 channels, bf16 compute, "
          "f32 params, bn_variance 'fast'")
    H, W = raw_host.image.shape[1:3]
    raw = raw_host.to(dev)
    args = (raw.image, raw.mask, raw.keypoint_uv,
            raw.keypoint_vis.to(torch.float32), raw.keypoint_xyz,
            raw.camera_K)
    kernel = scoremap_cuda.KERNEL
    before = kernel.launches
    t0 = time.perf_counter()
    blob = export.export_fused_pipeline(cfg, None, BATCH, (H, W), device=dev)
    export_s = time.perf_counter() - t0
    check(kernel.launches == before, "export traced without launching K1")
    path = os.path.join(root, "flagship_b256.pt2")
    export.save_exported(path, blob)
    inputs = os.path.join(root, "raw_b256.pt")
    torch.save([a.cpu() for a in args], inputs)
    out_path = os.path.join(root, "artifact_out.pt")

    server = load_serving_model(cfg, device=dev)
    with torch.inference_mode():
        ref_xyz, ref_uv = serve(server, raw, cfg, device=dev)
        eager_ms, eager_host_ms = median_call_ms(
            lambda: serve(server, raw, cfg, dev))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _SERVE_ARTIFACT, path,
                          inputs, out_path, str(SERVE_ITERS)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    process_s = time.perf_counter() - t0
    check(res.returncode == 0, "the loading process ran the artifact"
          + ("" if res.returncode == 0 else ": " + res.stderr[-2000:]))
    info = json.loads(res.stdout.strip().splitlines()[-1])
    other = [m for m in info["modules"] if m != "handpose_tpu_torch"
             and not m.startswith("handpose_tpu_torch.ops")]
    check(not other, f"the loading process imported the port's ops and "
          f"nothing else of the package: {other}")
    check(info["op_calls"] == 1, f"the program calls K1's operator "
          f"{info['op_calls']} time(s), == 1")
    check(info["launches"] == 1, f"one call of the loaded program launched "
          f"K1 {info['launches']} time(s), == 1")
    out = torch.load(out_path)
    errs = {k: float((out[k] - r.cpu()).abs().max())
            for k, r in (("xyz", ref_xyz), ("uv", ref_uv))}
    rels = {k: rel_err(r, out[k]) for k, r in (("xyz", ref_xyz),
                                                ("uv", ref_uv))}
    check(max(rels.values()) <= 1e-6,
          f"loaded artifact vs eager serve, b{BATCH}: max |diff| xyz "
          f"{errs['xyz']:.3g}, uv {errs['uv']:.3g} ({rels['xyz']:.3g}, "
          f"{rels['uv']:.3g} of range) <= 1e-6 of range")
    del server, out

    # ---- DiffusionHandPose: export_forward at b8, its default ladder ----
    dcfg = Config(model_name="DiffusionHandPose", input_channels=3,
                  dataset_root_dir=root)
    check(dcfg.num_timesteps == 400 and dcfg.num_sampling_timesteps == 200,
          "DiffusionHandPose at its default ladder: T 400, DDIM 200")
    small = RawBatch(*(a[:8] for a in raw))
    t0 = time.perf_counter()
    dblob = export.export_forward(dcfg, None, 8, device=dev)
    d_export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfn = export.load_exported(dblob)
    d_load_s = time.perf_counter() - t0
    dmodel = load_serving_model(dcfg, device=dev)
    with torch.inference_mode():
        d_ref = serve(dmodel, small, dcfg, device=dev)
        s = preprocess_batch(small, **serving_kwargs(dcfg))
        d_args = (model_input(s, 3).contiguous(),
                  s["camera_intrinsic_matrix"], s["keypoint_scale"],
                  s["keypoint_xyz_root"])
    d_out = dfn(*d_args)
    d_rels = [rel_err(r, o) for r, o in zip(d_ref, d_out)]
    check(max(d_rels) <= 1e-5 and all(bool(torch.isfinite(o).all())
                                       for o in d_out),
          f"DiffusionHandPose artifact vs serve, b8: xyz {d_rels[0]:.3g}, "
          f"uv {d_rels[1]:.3g} of range <= 1e-5")
    del dmodel, dfn
    torch.cuda.empty_cache()
    record = {
        "model": cfg.model_name, "batch": BATCH,
        "export_s": export_s, "artifact_bytes": len(blob),
        "load_s": info["load_s"], "loading_process_s": process_s,
        "artifact_serve_ms_median": info["median_ms"],
        "artifact_serve_ms": info["ms"],
        "artifact_serve_img_per_s_b256_device_resident":
            BATCH / info["median_ms"] * 1e3,
        "artifact_host_enqueue_ms_median": info["host_median_ms"],
        "eager_serve_ms_median": eager_ms,
        "eager_host_enqueue_ms_median": eager_host_ms,
        "eager_serve_img_per_s_b256_device_resident":
            BATCH / eager_ms * 1e3,
        "artifact_vs_eager_max_abs": errs, "artifact_vs_eager_rel": rels,
        "k1_launches_per_call": info["launches"],
        "diffusion": {"batch": 8, "export_s": d_export_s,
                      "artifact_bytes": len(dblob), "load_s": d_load_s,
                      "artifact_vs_serve_rel": d_rels},
    }
    print(f"export b{BATCH}: {export_s:.1f} s, {len(blob)} B, load "
          f"{info['load_s']:.2f} s; loaded {info['median_ms']:.3f} ms "
          f"({record['artifact_serve_img_per_s_b256_device_resident']:.1f} "
          f"img/s) vs eager serve {eager_ms:.3f} ms "
          f"({record['eager_serve_img_per_s_b256_device_resident']:.1f} "
          f"img/s); the host enqueues a call in {info['host_median_ms']:.2f} "
          f"ms (eager {eager_host_ms:.2f}); DiffusionHandPose b8 export "
          f"{d_export_s:.1f} s, "
          f"{len(dblob)} B", flush=True)
    return record, info["launches"]


def ops_phase(dev):
    """Each op of the library that no ported path calls, on the card
    against the host on the same seeded inputs at realistic sizes: the
    camera conversions, ``camera_xyz_to_uv``, ``absolute_to_rel_normed``,
    ``flip_right_hand``, ``bone_rel_trafo_inv``,
    ``render_gaussian_heatmap_3d`` (b8, 42 joints, 64^3),
    ``affine_warp_bilinear`` (64 x 256 x 256 x 3) and
    ``transform_input_to_output_space``; 1e-6 of range, 1e-5 for the warp
    (a matrix inverse).  The numpy helpers (``get_aug_config``,
    ``gen_trans_from_patch``, ``trans_point2d``, the bbox helpers) run on
    the host only."""
    from handpose_tpu_torch import ops
    rng = np.random.default_rng(5)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    B = BATCH
    world = f32(rng.normal(0, 0.2, (B, 42, 3)))
    R = ops.axis_angle_rot_mat(f32(rng.normal(0, 1, (B, 3))))
    t = f32(rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.7])
    f = f32(rng.uniform(400, 600, (B, 2)))
    c = f32(rng.uniform(100, 200, (B, 2)))
    cam = ops.world2cam(world, R, t)
    uvz = ops.cam2pixel(cam, f, c)
    xyz = f32(rng.normal(0, 0.04, (B, 21, 3)) + [0, 0, 0.6])
    K = f32([[480.0, 0, 160], [0, 470.0, 150], [0, 0, 1]])
    rel = ops.bone_rel_trafo(xyz - xyz[:, :1])
    joints = f32(rng.uniform(-4, 68, (8, 42, 3)))
    img = f32(rng.uniform(0, 1, (64, 256, 256, 3)))
    trans = f32(np.stack([ops.gen_trans_from_patch(
        *rng.uniform(60, 200, 2), *rng.uniform(80, 240, 2), 256, 256,
        rng.uniform(0.75, 1.25), rng.uniform(-45, 45)) for _ in range(64)]))
    jc = f32(np.concatenate([rng.uniform(0, 256, (64, 42, 2)),
                             rng.uniform(-300, 300, (64, 42, 1))], -1))
    valid = f32(rng.uniform(size=(64, 42)) > 0.2)
    hand = dict(root_joint_idx={"right": 20, "left": 41},
                joint_type={"right": np.arange(21),
                            "left": np.arange(21, 42)})
    cases = [
        ("world2cam", ops.world2cam, (world, R, t), {}, 1e-6),
        ("cam2pixel", ops.cam2pixel, (cam, f, c), {}, 1e-6),
        ("pixel2cam", ops.pixel2cam, (uvz, f, c), {}, 1e-6),
        ("camera_xyz_to_uv", ops.camera_xyz_to_uv, (xyz[0], K), {}, 1e-6),
        ("absolute_to_rel_normed", ops.absolute_to_rel_normed, (xyz,), {},
         1e-6),
        ("flip_right_hand", ops.flip_right_hand,
         (xyz, torch.from_numpy(rng.uniform(size=(B, 21)) > 0.5)), {}, 0.0),
        ("bone_rel_trafo_inv", ops.bone_rel_trafo_inv, (rel,), {}, 1e-6),
        ("render_gaussian_heatmap_3d", ops.render_gaussian_heatmap_3d,
         (joints, (64, 64, 64)), {}, 1e-6),
        ("affine_warp_bilinear", ops.affine_warp_bilinear,
         (img, trans, (256, 256)), {}, 1e-5),
        ("transform_input_to_output_space",
         ops.transform_input_to_output_space,
         (jc, valid, f32(rng.uniform(-300, 300, 64)), torch.ones(64)), hand,
         1e-6),
    ]
    errs = {}
    for name, fn, args, kw, tol in cases:
        host = fn(*args, **kw)
        card = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args),
                  **kw)
        torch.cuda.synchronize()
        host = host if isinstance(host, tuple) else (host,)
        card = card if isinstance(card, tuple) else (card,)
        e = max(rel_err(h.float(), k.float()) for h, k in zip(host, card))
        errs[name] = e
        check(e <= tol, f"{name} card vs host: {e:.3g} of range <= {tol}")
        del host, card
    torch.cuda.empty_cache()
    return {"card_vs_host_rel": errs}


def infer_cli_phase(dev, root, run_dir, best):
    """``python -m handpose_tpu_torch.infer``'s main on a run directory the
    augmented training phase wrote: ``--from_run`` with ``--pck`` gives
    the run's best validation MPJPE exactly; with ``--visualize_dir`` it
    does too and writes ``--visualize_n`` overlays that the port's
    decoder reads back at the crop's size; ``--export`` writes an
    artifact that loads and runs."""
    from handpose_tpu_torch.data import imageio
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.infer import export
    from handpose_tpu_torch.infer.__main__ import main as infer_main
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch import Config

    k1 = _counts()[0]
    k1.launches = 0
    t0 = time.perf_counter()
    res = infer_main(["--from_run", run_dir, "--pck",
                      "--batch_size", str(BATCH)])
    pck_s = time.perf_counter() - t0
    check(res["mpjpe"] == best, f"infer --from_run --pck: MPJPE "
          f"{res['mpjpe']!r} == the run's best {best!r}; AUC "
          f"{res['auc_20_50mm']:.4f}")
    vis = os.path.join(root, "overlays")
    t0 = time.perf_counter()
    mpjpe = infer_main(["--from_run", run_dir, "--batch_size", str(BATCH),
                        "--visualize_dir", vis])
    vis_s = time.perf_counter() - t0
    launches = k1.launches
    check(mpjpe == best, f"infer --from_run --visualize_dir: MPJPE "
          f"{mpjpe!r} == the run's best {best!r}")
    names = sorted(os.listdir(os.path.join(vis, "img")))
    check(names == [f"000_{i:03d}_pre.jpg" for i in range(8)],
          f"infer --visualize_dir wrote the 8 overlays {names}")
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    crop = cfg.crop_size
    imgs = imageio.decode_batch([os.path.join(vis, "img", n) for n in names],
                                crop, crop)
    check(imgs.shape == (8, crop, crop, 3) and imgs.std() > 0,
          f"the port's decoder reads the overlays back at {crop}x{crop}")
    path = os.path.join(root, "cli_export.pt2")
    infer_main(["--from_run", run_dir, "--export", path,
                "--export_batch", "4"])
    fn = export.load_exported_file(path)
    raw = RHDDataset(root, "evaluation", cache_decoded=True).raw_batch(
        range(4)).to(dev)
    with torch.inference_mode():
        s = preprocess_batch(raw, **serving_kwargs(cfg))
        xyz, uv = fn(model_input(s, cfg.input_channels).contiguous(),
                     s["camera_intrinsic_matrix"], s["keypoint_scale"],
                     s["keypoint_xyz_root"])
    check(tuple(xyz.shape) == (4, 21, 3) and bool(torch.isfinite(xyz).all()
                                                  and torch.isfinite(uv).all()),
          "infer --export wrote an artifact that loads and runs (b4)")
    return {"pck_mpjpe_mm": res["mpjpe"], "auc_20_50mm": res["auc_20_50mm"],
            "visualize_mpjpe_mm": mpjpe, "pck_run_s": pck_s,
            "visualize_run_s": vis_s, "overlays": len(names),
            "export_bytes": os.path.getsize(path)}, launches


def profile_phase(dev, root):
    """A fast_debug Worker with ``profile_epoch=0`` writes a chrome trace
    under ``run_dir/profile/`` whose kernel events name K1, K2's two
    kernels and K3."""
    import glob
    from handpose_tpu_torch.train import Worker
    logs = tempfile.mkdtemp(dir=root)
    cfg = train_config(root, logs, profile_epoch=0).replace(max_epoch=1)
    worker = Worker(cfg, device=dev)
    t0 = time.perf_counter()
    worker.run(fast_debug=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    traces = glob.glob(os.path.join(worker.run_dir, "profile", "*.json"))
    check(len(traces) == 1, f"profile_epoch=0 wrote one trace under "
          f"run_dir/profile/: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    want = {"K1": "scoremap_", "K2 partial": "moments_partial_kernel",
            "K2 final": "moments_final_kernel", "K3": "pool_bwd_tiled"}
    found = {k: sorted(n for n in kernels if v in n) for k, v in want.items()}
    check(all(found.values()), f"the trace's kernel events name K1, K2 and "
          f"K3: {found}")
    del worker
    torch.cuda.empty_cache()
    return {"trace_bytes": os.path.getsize(traces[0]),
            "kernel_event_names": len(kernels), "run_s": run_s,
            "kernels_found": found}


# ---------------------------------------------------------------------------
# data parallelism and the Worker's knobs: remat, steps_per_dispatch,
# debug_nans


def _all_augs():
    from handpose_tpu_torch.train import trainer
    return {f: True for f in trainer.AUG_FLAGS}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for a comparison of two paths: two
    runs of one computation are then bit-equal, so the comparison sees the
    paths and not the order of the card's atomic adds."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms (``torch.use_deterministic_
    algorithms``) on top of :func:`deterministic_cudnn`, for a comparison
    whose backward has atomic adds outside cuDNN; cuBLAS then needs
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the process first
    uses the card (``diffusion_remat_child``)."""
    with deterministic_cudnn():
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def max_leaf_err(want: dict, got: dict) -> float:
    """The largest |got - want| of a leaf over that leaf's max |want|."""
    assert sorted(want) == sorted(got)
    return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()
                     / max(float(np.abs(want[k]).max()), 1e-12))
               for k in want)


def worker_state(worker) -> dict:
    """The Worker's variables and Adam moments, as numpy by name."""
    return state_arrays(worker.model, worker.state)


def state_arrays(model, state) -> dict:
    """``model``'s variables and ``state``'s Adam moments, as numpy by
    name."""
    from handpose_tpu_torch.convert import export_flax_variables
    out = export_flax_variables(model)
    names = dict((id(p), n) for n, p in model.named_parameters())
    for p, st in state.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"adam/{names[id(p)]}/{k}"] = st[k].float().cpu().numpy()
    return out


def ddp_world1_phase(dev, root, raw_host):
    """(a) The augmented b256 Worker for two epochs of two steps inside a
    process group of one rank over NCCL, against the same Worker without
    a process group (both under deterministic cuDNN): the state bit-equal
    (bound 1e-6 of range), K1/K2/K3 at the Worker's counts and 40
    all-reduces of BatchNorm sums a step; then the step of each, timed in
    turns (plain, DDP, DDP, plain) at the default cuDNN settings."""
    import torch.distributed as dist
    from handpose_tpu_torch.nn import norm
    from handpose_tpu_torch.parallel import initialize_distributed
    from handpose_tpu_torch.train import Worker

    flags = _all_augs()
    runs, workers = {}, {}
    with deterministic_cudnn():
        for name in ("plain", "ddp"):
            if name == "ddp":
                initialize_distributed(f"localhost:{_free_port()}", 1, 0)
                check(dist.get_backend() == "nccl" and
                      dist.get_world_size() == 1,
                      "a process group of one rank over NCCL")
            logs = tempfile.mkdtemp(dir=root)
            worker = Worker(train_config(root, logs, **flags), run_dir=logs,
                            device=dev)
            check(worker.distributed == (name == "ddp"),
                  f"{name} Worker: distributed={worker.distributed}")
            torch.cuda.synchronize()
            reset_counts()
            norm.SYNC.all_reduces = 0
            best = worker.run()
            torch.cuda.synchronize()
            launches = check_worker_launches(worker, f"{name} Worker")
            runs[name] = {"state": worker_state(worker), "best": best,
                          "launches": launches,
                          "bn_all_reduces": norm.SYNC.all_reduces,
                          "steps": worker.state.step}
            workers[name] = worker
    raw = raw_host.to(dev)
    ms = {"plain": [], "ddp": []}
    for name in ("plain", "ddp", "ddp", "plain"):
        w = workers[name]
        ms[name].append(cuda_ms(lambda: w.train_step(
            w.state, raw, generator=w.generator), 3))
    dist.destroy_process_group()
    del workers, w
    torch.cuda.empty_cache()
    plain, ddp = runs["plain"], runs["ddp"]
    err = max_leaf_err(plain["state"], ddp["state"])
    bit = all(np.array_equal(plain["state"][k], ddp["state"][k])
              for k in plain["state"])
    check(err <= 1e-6, f"DDP at world 1 over NCCL: params, batch_stats and "
          f"Adam's moments after 4 steps within {err:.3g} <= 1e-6 of range "
          f"of the Worker without a process group (bit-equal: {bit})")
    check(ddp["bn_all_reduces"] == 40 * ddp["steps"]
          and plain["bn_all_reduces"] == 0,
          f"40 all-reduces of BatchNorm sums a step under the group "
          f"({ddp['bn_all_reduces']} in {ddp['steps']} steps), none without")
    check(abs(ddp["best"] - plain["best"]) <= 1e-6 * plain["best"],
          f"validation MPJPE {ddp['best']!r} == {plain['best']!r} (1e-6)")
    print(f"DDP world 1: step {ms['ddp']} ms, plain {ms['plain']} (in "
          "turns)", flush=True)
    return {"state_max_leaf_err": err, "bit_equal": bit,
            "bn_all_reduces": ddp["bn_all_reduces"],
            "step_ms": ms["ddp"], "plain_step_ms": ms["plain"],
            "val_mpjpe_mm": ddp["best"],
            "launches": dict(zip(("scoremap", "moments", "pool_bwd"),
                                 ddp["launches"]))}, ddp["launches"]


def _f32_step_inputs(root, dev):
    """The phase (b) configuration (f32, all six augmentations), the
    global raw batch on the card and the seeded model's flat weights."""
    from handpose_tpu_torch.data.rhd import RHDDataset
    cfg = train_config(root, "unused", compute_dtype="float32",
                       **_all_augs())
    raw = RHDDataset(root, "evaluation", cache_decoded=True).raw_batch(
        range(BATCH))
    return cfg, raw


def _two_steps(cfg, raw, dev, net_of=None, rank=None, seed=5):
    """Two fused steps of the seeded model on ``raw`` (``net_of(model)``
    replicates it; then ``raw`` is cut to this rank's rows), the draws
    from a generator seeded ``seed``: (losses, step-1 gradients,
    variables after, K1/K2/K3 launches)."""
    from handpose_tpu_torch.convert import export_flax_variables
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.parallel import shard_batch
    from handpose_tpu_torch.train import create_train_state
    from handpose_tpu_torch.train.steps import make_fused_train_step
    model = build_model(cfg).to(dev)
    state = create_train_state(model, cfg, 2)
    net = model if net_of is None else net_of(model)
    step = make_fused_train_step(net, cfg, None, serving_kwargs(cfg),
                                 _all_augs())
    raw = raw.to(dev)
    if rank is not None:
        raw = shard_batch(raw)
    g = torch.Generator(device=dev).manual_seed(seed)
    losses, grads = [], None
    reset_counts()
    for i in range(2):
        state, ls = step(state, raw, generator=g)
        losses.append({k: float(v) for k, v in ls.items()})
        if i == 0:
            grads = export_flax_variables(model, grads=True)
    torch.cuda.synchronize()
    launches = [k.launches for k in _counts()]
    return losses, grads, export_flax_variables(model), launches


def two_rank_child(rank, port, work, root, device="cuda"):
    """One rank of phase (b), in its own process on the one card: the
    2-rank fused step over gloo, then a Worker's padded validation, then
    a Worker whose preemption only rank 1 requests."""
    import torch.distributed as dist
    from handpose_tpu_torch.parallel import initialize_distributed, replicate
    from handpose_tpu_torch.train import PreemptionGuard, Worker
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    out = {}
    with deterministic_cudnn():
        cfg, raw = _f32_step_inputs(root, dev)
        losses, grads, variables, launches = _two_steps(
            cfg, raw, dev, replicate, rank)
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{f"grad/{k}": v for k, v in grads.items()},
             **{f"var/{k}": v for k, v in variables.items()})
    out.update(losses=losses, launches=launches)
    torch.cuda.empty_cache()
    # a Worker of the global b256 on the tree, float32: padded validation
    wcfg = cfg.replace(max_epoch=1, steps_per_dispatch=1,
                       save_log_dir=os.path.join(work, f"logs{rank}"))
    w = Worker(wcfg, device=dev)
    best = w.run()
    out["worker"] = {"val_mpjpe": best, "run_dir": w.run_dir,
                     "step": w.state.step}
    del w
    torch.cuda.empty_cache()
    # preemption requested on rank 1 only, inside its first step
    w = Worker(wcfg.replace(save_log_dir=os.path.join(work, f"pre{rank}")),
               device=dev)
    guard = w.enable_preemption_save(PreemptionGuard(signals=()))
    calls = [0]
    step = w.train_step

    def requesting_step(state, raw, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] == 1:
            guard.request()
        return step(state, raw, **kw)

    w.train_step = requesting_step
    w.run()
    out["preempt"] = {"calls": calls[0], "step": w.state.step,
                      "run_dir": w.run_dir, "requested": guard.requested}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def step_drifts(ref, other_losses, other_grads, other_vars, lr):
    """How far another run of two steps is from ``ref`` (``_two_steps``'s
    losses, step-1 gradients and variables): the step-1 losses (largest
    relative error), the step-1 gradients (largest error over the tree's
    largest gradient; None without ``other_grads``), the running
    statistics (largest error over each leaf's range) and the share of
    parameter elements whose updates differ by more than 0.1 lr."""
    losses, grads, variables = ref[0], ref[1], ref[2]
    loss = max(abs(other_losses[0][k] - v) / abs(v)
               for k, v in losses[0].items())
    grad = None
    if other_grads is not None:
        scale = max(float(np.abs(v).max()) for v in grads.values())
        grad = max(float(np.abs(other_grads[k] - v).max())
                   for k, v in grads.items()) / scale
    stats = max_leaf_err({k: v for k, v in variables.items()
                          if k.startswith("batch_stats/")},
                         {k: other_vars[k] for k in variables
                          if k.startswith("batch_stats/")})
    n_off = sum(int((np.abs(other_vars[k] - v) > 0.1 * lr).sum())
                for k, v in variables.items() if k.startswith("params/"))
    n_all = sum(v.size for k, v in variables.items()
                if k.startswith("params/"))
    return loss, grad, stats, n_off / n_all


def shard_mpjpe(ev, root, batch, dp, seed, dev):
    """The MPJPE of the Evaluator's eval step over each of ``dp`` data
    ranks' padded validation shards of the tree (global ``batch``), its
    sums added in float64: what the Worker's padded validation must
    give."""
    from handpose_tpu_torch.data.pipeline import _host_tensors
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.parallel import HostShardSampler
    ds = RHDDataset(root, "evaluation", cache_decoded=True)
    total = count = 0.0
    for r in range(dp):
        sampler = HostShardSampler(len(ds), batch, r, dp, shuffle=False,
                                   seed=seed)
        for idx, valid in sampler.local_batches_padded(0):
            host = ds.raw_batch(idx)
            host = host._replace(keypoint_vis=host.keypoint_vis
                                 * valid[:, None])
            m = ev.eval_step(_host_tensors(host, False).to(dev))
            total += float(m["mpjpe_sum"])
            count += float(m["mpjpe_count"])
    return total / count


def two_rank_phase(dev, root):
    """(b) Two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), float32, TF32 off, the global b256 (128 a rank) with all
    six augmentations: two fused steps against the 1-process steps on the
    same global batch, the yardstick being the 1-process steps with every
    BatchNorm's rows summed in reverse (plain sums); parameters and
    running statistics bit-equal on the ranks; a Worker's padded
    validation one MPJPE on both ranks, equal to the 1-process eval step
    over the same shards summed in float64 (1e-9); a preemption request
    on rank 1 alone stops both after one step, rank 0 alone writing."""
    import torch.multiprocessing as mp
    from handpose_tpu_torch.infer import Evaluator
    from handpose_tpu_torch.ops import moments

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, raw = _f32_step_inputs(root, dev)
    with deterministic_cudnn():
        ref = _two_steps(cfg, raw, dev)
        with mock.patch.object(moments, "_moments", lambda x2d, s:
                               moments.shifted_moments(x2d.flip(0), s)):
            yard = _two_steps(cfg, raw, dev)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(dir=root)
    t0 = time.perf_counter()
    mp.start_processes(two_rank_child,
                       args=(_free_port(), work, root, dev.type),
                       nprocs=2, start_method="spawn", join=True)
    ranks_s = time.perf_counter() - t0
    outs = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    arr = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]

    def part(a, p):
        return {k[len(p):]: v for k, v in a.items() if k.startswith(p)}

    check(all(np.array_equal(arr[0][k], arr[1][k]) for k in arr[0]),
          "two ranks: parameters, running statistics (and DDP's mean "
          "gradients) bit-equal on both")

    ours = step_drifts(ref, outs[0]["losses"], part(arr[0], "grad/"),
                       part(arr[0], "var/"), cfg.lr)
    yd = step_drifts(ref, yard[0], yard[1], yard[2], cfg.lr)
    check(ours[0] <= max(1e-6, 2 * yd[0]), f"two ranks vs one process: "
          f"step-1 losses within {ours[0]:.3g} relative (yardstick "
          f"{yd[0]:.3g})")
    # the yardstick, float32 rounding in another order, moves the gradient
    # by ~3e-4 of the tree's largest and the statistics by ~5e-4 of range
    # at full width: a fixed 1e-4 would hold the ranks below the float32
    # floor
    check(ours[1] <= 2 * yd[1] + 1e-6, f"two ranks vs one process: step-1 "
          f"gradients within {ours[1]:.3g} of the tree's largest <= 2 x "
          f"{yd[1]:.3g} (yardstick) + 1e-6")
    check(ours[2] <= 2 * yd[2] + 1e-6, f"two ranks vs one process: running "
          f"statistics after 2 steps within {ours[2]:.3g} of range <= 2 x "
          f"{yd[2]:.3g} (yardstick) + 1e-6")
    check(ours[3] <= 2 * yd[3] + 1e-3, f"two ranks vs one process: "
          f"{ours[3]:.3%} of parameter elements' updates differ by more "
          f"than 0.1 lr <= 2 x {yd[3]:.3%} (yardstick) + 0.1%")
    per_rank = [o["launches"] for o in outs]
    check(all(l == [2, 80, 4] for l in per_rank),
          f"each rank's two steps launched K1, K2, K3 {per_rank} times "
          "([2, 80, 4])")

    # padded validation: one MPJPE, the 1-process sums over the shards
    w0, w1 = outs[0]["worker"], outs[1]["worker"]
    check(w0["val_mpjpe"] == w1["val_mpjpe"] and w0["step"] == 2,
          f"padded validation: rank 0 {w0['val_mpjpe']!r} == rank 1 "
          f"{w1['val_mpjpe']!r} after {w0['step']} steps")
    ckpt = os.path.join(w0["run_dir"], "checkpoint")
    ev = Evaluator(cfg.replace(save_log_dir=work), weights=ckpt, device=dev)
    want = shard_mpjpe(ev, root, BATCH, 2, cfg.seed, dev)
    whole = ev.evaluate()
    check(abs(w0["val_mpjpe"] - want) <= 1e-9 * want,
          f"padded validation {w0['val_mpjpe']!r} == the 1-process eval "
          f"step over the same shards, summed in float64, {want!r} (1e-9); "
          f"the Evaluator's whole split {whole!r}")
    p0, p1 = outs[0]["preempt"], outs[1]["preempt"]
    check(p1["requested"] and not p0["requested"]
          and p0["calls"] == p1["calls"] == 1
          and p0["step"] == p1["step"] == 1,
          f"preemption on rank 1 alone: both ranks stopped after "
          f"{p0['calls']}, {p1['calls']} steps")
    check(os.path.exists(os.path.join(p0["run_dir"], "checkpoint"))
          and not os.path.exists(os.path.join(work, "pre1"))
          and not os.path.exists(os.path.join(work, "logs1")),
          "only rank 0 wrote a run directory and checkpoints")
    return {"loss_rel": ours[0], "grad_rel": ours[1], "stats_rel": ours[2],
            "update_beyond_0.1lr": ours[3], "yardstick": list(yd),
            "val_mpjpe_mm": w0["val_mpjpe"], "val_shards_f64_mm": want,
            "evaluator_whole_split_mm": whole, "ranks_s": ranks_s,
            "launches_per_rank": per_rank}, [a + b for a, b in
                                             zip(*per_rank)]


def diffusion_remat_child(index, root, work, device="cuda"):
    """Phase (c)'s DiffusionHandPose at b8 (T 400, DDIM 200), in a process
    of its own: two plain steps and a remat one from one seeded model
    and generator, under torch's deterministic algorithms, whose cuBLAS
    workspace setting is made here before the card is first used; each
    step's losses, seconds, gradients and the generator's state after it
    go to ``work``.  Its backward has atomic adds outside cuDNN: under
    cuDNN's deterministic algorithms alone two plain steps came 9.4e-6
    apart and the remat one 9.6e-3 (of the tree's largest gradient) in
    one run, 8.9e-3 and 8.4e-3 in another."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    from handpose_tpu_torch.convert import export_flax_variables
    from handpose_tpu_torch.data.rhd import RHDDataset
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import create_train_state
    from handpose_tpu_torch.train.steps import make_fused_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    raw8 = RHDDataset(root, "evaluation", cache_decoded=True).raw_batch(
        range(8)).to(dev)
    cfg = model_config(root, DIFFUSION, logs=tempfile.mkdtemp(dir=root))
    base = build_model(cfg)
    with deterministic_algorithms():
        for i, remat in enumerate((False, False, True)):
            model = build_model(cfg)
            model.load_state_dict(base.state_dict())
            model.to(dev)
            c = cfg.replace(remat=remat)
            state = create_train_state(model, c)
            step = make_fused_train_step(model, c, None, serving_kwargs(c))
            g = torch.Generator(device=dev).manual_seed(3)
            t0 = time.perf_counter()
            state, losses = step(state, raw8, generator=g)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            np.savez(os.path.join(work, f"grads{i}.npz"),
                     **export_flax_variables(model, grads=True))
            np.save(os.path.join(work, f"generator{i}.npy"),
                    g.get_state().numpy())
            with open(os.path.join(work, f"step{i}.json"), "w") as f:
                json.dump({"losses": {k: float(v)
                                      for k, v in losses.items()},
                           "seconds": seconds}, f)
            del model, state, step
            torch.cuda.empty_cache()


def remat_phase(dev, root, raw_host, plain):
    """(c) The flagship's Worker at b256 with ``remat=True``: two steps
    equal to the plain Worker's (deterministic cuDNN; bound 1e-6 of
    range), K2 80 times a step; the step's time and peak memory beside
    the plain step's, measured here; DiffusionHandPose at b8 (T 400, DDIM
    200), under torch's deterministic algorithms: one remat step's losses
    equal to the plain one's, its gradient within twice the distance
    between two plain steps (both 0 there), the generator's state after
    it the same."""
    from handpose_tpu_torch.convert import export_flax_variables
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import Worker, create_train_state
    from handpose_tpu_torch.train.steps import make_fused_train_step

    raw = raw_host.to(dev)
    runs, launches = {}, None
    for remat in (False, True):
        logs = tempfile.mkdtemp(dir=root)
        worker = Worker(train_config(root, logs, remat=remat), run_dir=logs,
                        device=dev)
        with deterministic_cudnn():
            torch.cuda.synchronize()
            reset_counts()
            worker.run_epoch(0, "training")
            torch.cuda.synchronize()
        counts = [k.launches for k in _counts()]
        check(counts == [2, (160 if remat else 80), 4],
              f"remat={remat} Worker: two steps launched K1, K2, K3 {counts} "
              f"times (K2 {'80' if remat else '40'} a step)")
        if remat:
            launches = counts
        state = worker_state(worker)
        # time and peak of a step at the default cuDNN settings
        g = worker.generator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: worker.train_step(worker.state, raw,
                                               generator=g), 3)
        runs[remat] = (state, ms, torch.cuda.max_memory_allocated())
        del worker
        torch.cuda.empty_cache()
    err = max_leaf_err(runs[False][0], runs[True][0])
    check(err <= 1e-6, f"remat Worker: state after 2 steps within {err:.3g} "
          "<= 1e-6 of range of the plain Worker's (statistics moved once)")
    (_, p_ms, p_peak), (_, r_ms, r_peak) = runs[False], runs[True]
    print(f"remat b{BATCH}: step {r_ms:.3f} ms (plain {p_ms:.3f}), peak "
          f"{r_peak} B (plain {p_peak})", flush=True)

    # DiffusionHandPose at b8: one step, the draws made once, in a
    # process of its own (diffusion_remat_child)
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(dir=root)
    mp.start_processes(diffusion_remat_child, args=(root, work, dev.type),
                       nprocs=1, start_method="spawn", join=True)
    out = []
    for i in range(3):
        with open(os.path.join(work, f"step{i}.json")) as f:
            meta = json.load(f)
        out.append((meta["losses"],
                    dict(np.load(os.path.join(work, f"grads{i}.npz"))),
                    torch.from_numpy(np.load(os.path.join(
                        work, f"generator{i}.npy"))), meta["seconds"]))
    (lp, gp, sp, tp), (_, gq, _, _), (lr, gr, sr, tr) = out
    scale = max(float(np.abs(v).max()) for v in gp.values())

    def grad_rel(a, b):
        return max(float(np.abs(a[k] - b[k]).max()) for k in a) / scale

    d_err, d_yard = grad_rel(gp, gr), grad_rel(gp, gq)
    check(lp == lr and torch.equal(sp, sr) and d_err <= 2 * d_yard + 1e-6,
          f"DiffusionHandPose b8 remat: losses equal ({lr}), the generator's "
          f"state after the step the plain step's (draws made once), the "
          f"gradient within {d_err:.3g} of the tree's largest <= 2 x "
          f"{d_yard:.3g} (plain vs plain) + 1e-6")
    return {"step_ms": r_ms, "plain_step_ms": p_ms,
            "max_memory_allocated_bytes": r_peak,
            "plain_max_memory_allocated_bytes": p_peak,
            "plain_step_ms_pr8": 157.941,
            "plain_max_memory_allocated_bytes_pr8": 17116550656,
            "state_max_leaf_err": err,
            "diffusion_b8_step_s": tr, "diffusion_b8_plain_step_s": tp,
            "diffusion_b8_grad_rel": d_err,
            "diffusion_b8_grad_rel_plain_vs_plain": d_yard,
            "launches": dict(zip(("scoremap", "moments", "pool_bwd"),
                                 launches))}, launches


def groups_phase(dev, root):
    """(d) ``steps_per_dispatch``: k=2 at b256 (one full group an epoch,
    through ``multi_step``) and the default 8 (every step a tail step),
    two epochs of training each: the step counts, the states equal
    (deterministic cuDNN, 1e-6 of range), a group's time beside single
    steps'; then a request while a group is buffered drops it."""
    from handpose_tpu_torch.train import PreemptionGuard, Worker

    runs = {}
    for k in (2, 8):
        logs = tempfile.mkdtemp(dir=root)
        worker = Worker(train_config(root, logs, steps_per_dispatch=k),
                        run_dir=logs, device=dev)
        calls = {"multi": 0, "single": 0}
        for name, key in (("multi_step", "multi"), ("train_step", "single")):
            fn = getattr(worker, name)

            def counted(state, raw, _fn=fn, _key=key, **kw):
                calls[_key] += 1
                return _fn(state, raw, **kw)

            setattr(worker, name, counted)
        with deterministic_cudnn():
            torch.cuda.synchronize()
            reset_counts()
            for epoch in (0, 1):
                worker.run_epoch(epoch, "training")
            torch.cuda.synchronize()
        counts = [c.launches for c in _counts()]
        check(counts == [4, 160, 8], f"steps_per_dispatch={k}: 4 steps "
              f"launched K1, K2, K3 {counts} times")
        want = {"multi": 2, "single": 0} if k == 2 else \
            {"multi": 0, "single": 4}
        check(calls == want and worker.state.step == 4,
              f"steps_per_dispatch={k}: {calls} dispatches for "
              f"{worker.state.step} steps ({want})")
        runs[k] = (worker_state(worker), list(worker.stats.train_seconds),
                   counts)
        del worker
        torch.cuda.empty_cache()
    err = max_leaf_err(runs[8][0], runs[2][0])
    check(err <= 1e-6, f"groups of 2 == single steps: state within "
          f"{err:.3g} <= 1e-6 of range")
    # a request while a group is buffered: the group is dropped
    logs = tempfile.mkdtemp(dir=root)
    worker = Worker(train_config(root, logs, steps_per_dispatch=2),
                    run_dir=logs, device=dev)
    guard = worker.enable_preemption_save(PreemptionGuard(signals=()))
    batches = worker._epoch_batches

    def requesting(split, epoch):
        for idx, b in enumerate(batches(split, epoch)):
            if idx == 1:
                guard.request()
            yield b

    worker._epoch_batches = requesting
    worker.run()
    saved = torch.load(os.path.join(logs, "checkpoint", "train_state.pt"),
                       weights_only=True)
    check(worker.state.step == 0 and saved["epoch"] == 0
          and saved["step"] == 0,
          "a request with one batch of a group of 2 buffered: the group "
          f"dropped (steps {worker.state.step}), the checkpoint pinned to "
          f"epoch {saved['epoch']}")
    del worker
    torch.cuda.empty_cache()
    return {"k2_step_s": runs[2][1], "k8_step_s": runs[8][1],
            "k2_median_step_ms_after_first_group": 1e3 * float(np.median(
                runs[2][1][2:])),
            "k8_median_step_ms_after_first": 1e3 * float(np.median(
                runs[8][1][1:])),
            "state_max_leaf_err": err}, runs[2][2]


def debug_nans_phase(dev, root, plain):
    """(e) ``debug_nans`` on the flagship's Worker at b256: two steps
    (their time beside the plain Worker's), then a NaN planted in one
    conv kernel raises ``FloatingPointError`` naming that module."""
    from handpose_tpu_torch.train import Worker

    logs = tempfile.mkdtemp(dir=root)
    worker = Worker(train_config(root, logs, debug_nans=True), run_dir=logs,
                    device=dev)
    torch.cuda.synchronize()
    reset_counts()
    worker.run_epoch(0, "training")
    worker.run_epoch(1, "training")
    torch.cuda.synchronize()
    counts = [k.launches for k in _counts()]
    check(counts == [4, 160, 8], f"debug_nans Worker: 4 steps launched K1, "
          f"K2, K3 {counts} times")
    med = 1e3 * float(np.median(worker.stats.train_seconds[1:]))
    conv = worker.model.PosePrior_net.backbone.trunk.BasicBlock_2.Conv_1
    with torch.no_grad():
        conv.weight[0, 0, 0, 0] = float("nan")
    try:
        worker.run_epoch(2, "training")
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None and
          "PosePrior_net.backbone.trunk.BasicBlock_2.Conv_1" in raised,
          f"a NaN planted in PosePrior_net's BasicBlock_2.Conv_1 kernel "
          f"raised FloatingPointError: {raised}")
    print(f"debug_nans: median step {med:.1f} ms (plain Worker "
          f"{plain['median_step_ms_after_first']:.1f})", flush=True)
    del worker
    torch.cuda.empty_cache()
    return {"median_step_ms_after_first": med,
            "plain_median_step_ms_after_first":
                plain["median_step_ms_after_first"],
            "error": raised}, counts


# phase (f): the global batch (64 rows a data rank), and the layout rule's
# prediction over the flagship (a CPU count): 45 of its 142 parameter
# tensors sharded, 96.95 of its 97.27 MB, so a rank stores 49.8% less of
# parameters and Adam moments than the replicated state
DP_TP_BATCH = 128
DP_TP_PREDICTED_CUT = 0.498


def _digests(arrays: dict) -> dict:
    import hashlib
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def dp_tp_child(rank, port, work, root, device="cuda"):
    """One rank of phase (f), in its own process on the one card: the dry
    run (``parallel/dryrun.py``: dp 2 x tp 2, full width, float32, the
    global b128 with all six augmentations, two fused steps), then a
    Worker with ``mesh_shape=(2, 2)`` for one epoch with padded
    validation, the dry run under deterministic cuDNN, the Worker at the
    default cuDNN settings."""
    import torch.distributed as dist
    from handpose_tpu_torch.parallel import initialize_distributed
    from handpose_tpu_torch.parallel.dryrun import dryrun
    from handpose_tpu_torch.train import Worker
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    initialize_distributed(f"localhost:{port}", 4, rank, backend="gloo")
    out = {}
    with deterministic_cudnn():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        run = dryrun(crop=256, batch=DP_TP_BATCH, steps=2,
                     augmentations=tuple(_all_augs()), device=dev)
        torch.cuda.synchronize()
        out["dryrun_s"] = time.perf_counter() - t0
        out["launches"] = [k.launches for k in _counts()]
    arrays = state_arrays(run.state.model, run.state)
    arrays.update((f"grad1/{k}", v) for k, v in run.grads.items())
    out.update(losses=run.losses, stored=run.stored,
               replicated=run.replicated, shard_rows=run.shard_rows,
               mesh=run.mesh.shape,
               index=[run.mesh.data_index, run.mesh.model_index],
               digests=_digests(arrays),
               peak_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"), **arrays)
    del run, arrays
    torch.cuda.empty_cache()
    cfg = train_config(root, os.path.join(work, f"logs{rank}"),
                       compute_dtype="float32", **_all_augs()).replace(
        batch_size=DP_TP_BATCH, infer_batch_size=DP_TP_BATCH, max_epoch=1,
        steps_per_dispatch=1, mesh_shape=(2, 2),
        mesh_axis_names=("data", "model"))
    # the default cuDNN settings: the ranks of one data index agree by
    # construction (distributed.data_sum_, DDP's mean over every rank)
    w = Worker(cfg, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    best = w.run()
    torch.cuda.synchronize()
    out["worker"] = {"val_mpjpe": best, "run_dir": w.run_dir,
                     "steps": w.state.step, "dp": w.dp,
                     "data_rank": w.data_rank,
                     "val_batches": -(-len(w.val_ds) // DP_TP_BATCH),
                     "launches": [k.launches for k in _counts()],
                     "run_s": time.perf_counter() - t0,
                     "median_step_ms": 1e3 * float(np.median(
                         w.stats.train_seconds[1:]))}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def dp_tp_phase(dev, root, card):
    """(f) Four ranks on the one card over gloo, dp 2 x tp 2
    (``parallel/sharding.py``), float32, TF32 off, deterministic cuDNN:
    the dry run's two fused steps of the global b128 (all six
    augmentations) against the 1-process steps on the same batch and
    draws, within twice phase (b)'s yardstick (reversed BatchNorm sums),
    the step-1 gradients gathered whole included; the state and those
    gradients gathered whole bit-equal on the four ranks; every sharded
    parameter stored as half its rows, and a rank's parameter and Adam
    bytes within 5% of the rule's prediction; K1/K2/K3 at a step's
    counts on every rank; then a ``mesh_shape=(2, 2)`` Worker at the
    default cuDNN settings, its padded validation one MPJPE on every
    rank, equal (1e-9) to the 1-process eval step over the two data
    shards summed in float64."""
    import torch.multiprocessing as mp
    from handpose_tpu_torch.infer import Evaluator
    from handpose_tpu_torch.ops import moments
    from handpose_tpu_torch.parallel.dryrun import (dryrun_config,
                                                    dryrun_inputs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dryrun_config(256, DP_TP_BATCH)
    raw = dryrun_inputs(DP_TP_BATCH)
    # the dry run draws its augmentations from a generator seeded 1
    with deterministic_cudnn():
        ref = _two_steps(cfg, raw, dev, seed=1)
        with mock.patch.object(moments, "_moments", lambda x2d, s:
                               moments.shifted_moments(x2d.flip(0), s)):
            yard = _two_steps(cfg, raw, dev, seed=1)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(dir=root)
    t0 = time.perf_counter()
    mp.start_processes(dp_tp_child, args=(_free_port(), work, root,
                                          dev.type),
                       nprocs=4, start_method="spawn", join=True)
    ranks_s = time.perf_counter() - t0
    outs = []
    for r in range(4):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    got = dict(np.load(os.path.join(work, "rank0.npz")))
    check([o["index"] for o in outs] == [[0, 0], [0, 1], [1, 0], [1, 1]]
          and all(o["mesh"] == {"data": 2, "model": 2} for o in outs),
          "four ranks laid out dp 2 x tp 2, rank r at (r // 2, r % 2)")
    check(all(o["digests"] == outs[0]["digests"] for o in outs)
          and all(o["losses"] == outs[0]["losses"] for o in outs),
          f"four ranks: parameters, statistics, Adam's moments and the "
          f"step-1 gradients gathered whole bit-equal on all "
          f"({len(outs[0]['digests'])} arrays), and the losses")
    got_grads = {k[len("grad1/"):]: v for k, v in got.items()
                 if k.startswith("grad1/")}
    ours = step_drifts(ref, outs[0]["losses"], got_grads, got, cfg.lr)
    yd = step_drifts(ref, yard[0], yard[1], yard[2], cfg.lr)
    check(ours[0] <= max(1e-6, 2 * yd[0]), f"dp 2 x tp 2 vs one process: "
          f"step-1 losses within {ours[0]:.3g} relative (yardstick "
          f"{yd[0]:.3g})")
    check(ours[1] <= 2 * yd[1] + 1e-6, f"dp 2 x tp 2 vs one process: "
          f"step-1 gradients within {ours[1]:.3g} of the tree's largest <= "
          f"2 x {yd[1]:.3g} (yardstick) + 1e-6")
    check(ours[2] <= 2 * yd[2] + 1e-6, f"dp 2 x tp 2 vs one process: "
          f"running statistics after 2 steps within {ours[2]:.3g} of range "
          f"<= 2 x {yd[2]:.3g} (yardstick) + 1e-6")
    check(ours[3] <= 2 * yd[3] + 1e-3, f"dp 2 x tp 2 vs one process: "
          f"{ours[3]:.3%} of parameter elements' updates differ by more "
          f"than 0.1 lr <= 2 x {yd[3]:.3%} (yardstick) + 0.1%")
    rows = outs[0]["shard_rows"]
    n_params = sum(k.startswith("params/") for k in ref[2])
    check(rows and all(o["shard_rows"] == rows for o in outs)
          and all(kept * 2 == whole for kept, whole in rows.values()),
          f"every rank stores O/2 rows of each of the {len(rows)} sharded "
          f"parameters (of {n_params}) and of their two Adam moments")
    st, rp = outs[0]["stored"], outs[0]["replicated"]
    total, whole = st["params"] + st["adam"], rp["params"] + rp["adam"]
    cut = 1 - total / whole
    check(all(o["stored"] == st for o in outs)
          and abs(total / ((1 - DP_TP_PREDICTED_CUT) * whole) - 1) <= 0.05,
          f"a rank stores {st['params']} B of parameters + {st['adam']} B "
          f"of Adam moments = {total} B against {whole} B replicated "
          f"(-{cut:.2%}; predicted -{DP_TP_PREDICTED_CUT:.1%}, within 5%)")
    print(f"dp x tp bytes per rank: parameters {st['params']} + Adam "
          f"{st['adam']} = {total} B; replicated {rp['params']} + "
          f"{rp['adam']} = {whole} B (-{cut:.2%}); card: {card}",
          flush=True)
    per_rank = [o["launches"] for o in outs]
    check(all(c == [2, 80, 4] for c in per_rank),
          f"each rank's two dry-run steps launched K1, K2, K3 {per_rank} "
          "times ([2, 80, 4])")
    ws = [o["worker"] for o in outs]
    worker_launches = [w["launches"] for w in ws]
    steps, n_val = ws[0]["steps"], ws[0]["val_batches"]
    check(all(c == [steps + n_val, 40 * steps, 2 * steps]
              for c in worker_launches),
          f"each rank's mesh Worker ({steps} steps, {n_val} validation "
          f"batches) launched K1, K2, K3 {worker_launches} times")
    check([(w["dp"], w["data_rank"]) for w in ws]
          == [(2, 0), (2, 0), (2, 1), (2, 1)]
          and len({w["val_mpjpe"] for w in ws}) == 1,
          f"mesh Worker: padded validation one MPJPE on all four ranks "
          f"{[w['val_mpjpe'] for w in ws]}")
    ckpt = os.path.join(ws[0]["run_dir"], "checkpoint")
    ev = Evaluator(train_config(root, work, compute_dtype="float32"),
                   weights=ckpt, device=dev)
    want = shard_mpjpe(ev, root, DP_TP_BATCH, 2, ev.cfg.seed, dev)
    check(abs(ws[0]["val_mpjpe"] - want) <= 1e-9 * want
          and all(not os.path.exists(os.path.join(work, f"logs{r}"))
                  for r in (1, 2, 3)),
          f"mesh Worker: padded validation {ws[0]['val_mpjpe']!r} == the "
          f"1-process eval step over the two data shards, summed in "
          f"float64, {want!r} (1e-9); only rank 0 wrote")
    launches = [sum(c[i] for c in per_rank + worker_launches)
                for i in range(3)]
    return {"loss_rel": ours[0], "grad_rel": ours[1], "stats_rel": ours[2],
            "update_beyond_0.1lr": ours[3], "yardstick": list(yd),
            "sharded_tensors": len(rows), "parameter_tensors": n_params,
            "bytes_per_rank": st, "bytes_replicated": rp,
            "cut_per_rank": cut, "val_mpjpe_mm": ws[0]["val_mpjpe"],
            "val_shards_f64_mm": want, "ranks_s": ranks_s,
            "dryrun_s": [o["dryrun_s"] for o in outs],
            "worker_run_s": [w["run_s"] for w in ws],
            "worker_median_step_ms": [w["median_step_ms"] for w in ws],
            "peak_bytes_per_rank": [o["peak_bytes"] for o in outs],
            "launches_per_rank": per_rank,
            "worker_launches_per_rank": worker_launches}, launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from handpose_tpu_torch.data import imageio
    from handpose_tpu_torch.data.interhand import write_synthetic_interhand
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

    sources = [m.SOURCE for m in (scoremap_cuda, moments_cuda, pool_bwd_cuda,
                                  imageio)]
    t0 = time.perf_counter()
    logs = cuda_build.build_many(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s (one "
          "compiler each, together)", flush=True)
    for name, log in logs.items():
        if log:
            print(f"--- {cuda_build.source_path(name).name} ---\n"
                  f"{log.strip()}", flush=True)

    with tempfile.TemporaryDirectory() as root:
        # the RHD tree as PNGs, each written array kept to check the
        # decoded cache against
        written = {}
        write_png = imageio.write_png

        def recording_write(path, img):
            written[path] = np.array(img)
            write_png(path, img)

        t0 = time.perf_counter()
        with mock.patch.object(imageio, "write_png", recording_write):
            write_synthetic_rhd(root, "evaluation", n=N_SAMPLES, seed=0)
        rhd_write_s = time.perf_counter() - t0
        print(f"wrote the {N_SAMPLES}-sample RHD tree (PNGs) in "
              f"{rhd_write_s:.1f} s", flush=True)
        decode = decode_phase(dev, root, written)
        decode["rhd_tree_write_s"] = rhd_write_s
        del written
        raw_host = RHDDataset(root, "evaluation",
                              cache_decoded=True).raw_batch(range(BATCH))
        k1 = scoremap_phase(dev, raw_host)
        k2 = moments_phase(dev)
        k3 = pool_bwd_phase(dev)
        torch.cuda.empty_cache()
        serving, k1_serving = serving_phase(dev, root, raw_host)
        torch.cuda.empty_cache()
        training, (k1_train, k2_train, k3_train), k2_shapes = \
            training_phase(dev, root, raw_host)
        torch.cuda.empty_cache()
        augmented, (k1_aug, k2_aug, k3_aug), aug_run = \
            augmented_training_phase(dev, root, raw_host, training)
        preemption = preemption_phase(dev, root)
        t_dp = time.perf_counter()
        ddp_world1, k_ddp = ddp_world1_phase(dev, root, raw_host)
        two_ranks, k_ranks = two_rank_phase(dev, root)
        remat, k_remat = remat_phase(dev, root, raw_host, training)
        groups, k_groups = groups_phase(dev, root)
        debug_nans, k_nans = debug_nans_phase(dev, root, training)
        dp_phases_s = time.perf_counter() - t_dp
        print(f"DDP, two ranks, remat, groups and debug_nans phases: "
              f"{dp_phases_s:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dp_tp, k_dp_tp = dp_tp_phase(dev, root, card)
        dp_tp["phase_s"] = time.perf_counter() - t0
        print(f"dp x tp phase: {dp_tp['phase_s']:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t_new = time.perf_counter()
        exported, k1_export = export_phase(dev, root, raw_host)
        ops_library = ops_phase(dev)
        infer_cli, k1_infer_cli = infer_cli_phase(
            dev, root, aug_run, augmented["val_mpjpe_mm"])
        reset_counts()
        profile = profile_phase(dev, root)
        profile_launches = [k.launches for k in _counts()]
        new_phases_s = time.perf_counter() - t_new
        print(f"export, ops, inference CLI and profile phases: "
              f"{new_phases_s:.1f} s", flush=True)
        ih_root = os.path.join(root, "interhand")
        t0 = time.perf_counter()
        for split, seed in (("train", 1), ("val", 2)):
            write_synthetic_interhand(ih_root, split, n=N_SAMPLES,
                                      seed=seed, image_sizes=IH_SIZES)
        ih_write_s = time.perf_counter() - t0
        print(f"wrote the InterHand tree (2 x {N_SAMPLES} JPEG frames) in "
              f"{ih_write_s:.1f} s", flush=True)
        ih_serving, k1_ih_serving, ih_k1_err = interhand_serving_phase(
            dev, ih_root)
        ih_serving["tree_write_s"] = ih_write_s
        ih_training, (k1_ih_train, k2_ih_train, k3_ih_train) = \
            interhand_training_phase(dev, ih_root)
        r50_serving, k1_r50_serving = model_serving_phase(
            dev, root, raw_host)
        r50_training, r50_launches = {}, {}
        for model in RESNET50_MODELS:
            r50_training[model], r50_launches[model], shapes = \
                model_training_phase(dev, root, raw_host, model)
            if model == "Hand3DPoseNet":
                r50_k2_shapes = shapes
        stems, stem_launches = stems_phase(dev, root, raw_host)
        fk_mano = fk_mano_phase(dev)
        fm_serving, fm_training, k1_fm_serving, fm_launches = {}, {}, {}, {}
        for model in FK_MANO_MODELS:
            fm_serving[model], k1_fm_serving[model] = \
                model_serving_phase(dev, root, raw_host, model)
            fm_training[model], fm_launches[model], shapes = \
                model_training_phase(dev, root, raw_host, model,
                                        max_epoch=1)
            if model == "ThreeHandShapeAndPoseMANO":
                mano_k2_shapes = shapes
        diffusion = diffusion_phase(dev, root, raw_host)
        diff_serving, k1_diff_serving = model_serving_phase(
            dev, root, raw_host, DIFFUSION)
        diff_training, diff_launches, _ = model_training_phase(
            dev, root, raw_host, DIFFUSION, max_epoch=1)
    moments_per_step(k2, k2_shapes, training["steps"], "flagship")
    moments_per_step(k2, r50_k2_shapes,
                     r50_training["Hand3DPoseNet"]["steps"], "resnet50")
    moments_per_step(k2, mano_k2_shapes,
                     fm_training["ThreeHandShapeAndPoseMANO"]["steps"],
                     "resnet_mano")
    k1["max_abs_err"] = max(k1["max_abs_err"], ih_k1_err)
    k1["launches_by_path"] = {
        "serving": k1_serving, "training": k1_train,
        "augmented_training": k1_aug, "interhand_serving": k1_ih_serving,
        "interhand_training": k1_ih_train,
        "resnet50_serving": k1_r50_serving,
        **{f"{m}_training": r50_launches[m][0] for m in RESNET50_MODELS},
        "k7s2_step": stem_launches[0],
        **{f"{m}_serving": k1_fm_serving[m] for m in FK_MANO_MODELS},
        **{f"{m}_training": fm_launches[m][0] for m in FK_MANO_MODELS},
        f"{DIFFUSION}_serving": k1_diff_serving,
        f"{DIFFUSION}_training": diff_launches[0],
        "export": k1_export, "infer_cli": k1_infer_cli,
        "profile_worker": profile_launches[0], "ddp_world1": k_ddp[0],
        "two_ranks": k_ranks[0], "remat": k_remat[0],
        "groups_k2": k_groups[0], "debug_nans": k_nans[0],
        "dp_tp": k_dp_tp[0]}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k2["launches_by_path"] = {
        "training": k2_train, "augmented_training": k2_aug,
        "interhand_training": k2_ih_train,
        **{f"{m}_training": r50_launches[m][1] for m in RESNET50_MODELS},
        "k7s2_step": stem_launches[1],
        **{f"{m}_training": fm_launches[m][1] for m in FK_MANO_MODELS},
        f"{DIFFUSION}_training": diff_launches[1],
        "profile_worker": profile_launches[1], "ddp_world1": k_ddp[1],
        "two_ranks": k_ranks[1], "remat": k_remat[1],
        "groups_k2": k_groups[1], "debug_nans": k_nans[1],
        "dp_tp": k_dp_tp[1]}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k3["launches_by_path"] = {
        "training": k3_train, "augmented_training": k3_aug,
        "interhand_training": k3_ih_train,
        **{f"{m}_training": r50_launches[m][2] for m in RESNET50_MODELS},
        "k7s2_step": stem_launches[2],
        **{f"{m}_training": fm_launches[m][2] for m in FK_MANO_MODELS},
        f"{DIFFUSION}_training": diff_launches[2],
        "profile_worker": profile_launches[2], "ddp_world1": k_ddp[2],
        "two_ranks": k_ranks[2], "remat": k_remat[2],
        "groups_k2": k_groups[2], "debug_nans": k_nans[2],
        "dp_tp": k_dp_tp[2]}
    k3["launches"] = sum(k3["launches_by_path"].values())
    k3["launches_by_variant"] = training["pool_bwd_launches_by_variant"]
    for record in (decode, serving, training, augmented, preemption,
                   ddp_world1, two_ranks, remat, groups, debug_nans, dp_tp,
                   ih_serving, ih_training, r50_serving, stems,
                   *r50_training.values(), fk_mano, *fm_serving.values(),
                   *fm_training.values(), diffusion, diff_serving,
                   diff_training, exported, ops_library, infer_cli,
                   profile):
        record["card"] = card
    exported["new_phases_s"] = new_phases_s
    print(json.dumps({"decode": decode}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"augmented_training": augmented}), flush=True)
    print(json.dumps({"preemption": preemption}), flush=True)
    groups["phases_s"] = dp_phases_s
    print(json.dumps({"ddp_world1": ddp_world1}), flush=True)
    print(json.dumps({"two_ranks": two_ranks}), flush=True)
    print(json.dumps({"remat": remat}), flush=True)
    print(json.dumps({"steps_per_dispatch": groups}), flush=True)
    print(json.dumps({"debug_nans": debug_nans}), flush=True)
    print(json.dumps({"dp_tp": dp_tp}), flush=True)
    print(json.dumps({"export": exported}), flush=True)
    print(json.dumps({"ops_library": ops_library}), flush=True)
    print(json.dumps({"infer_cli": infer_cli}), flush=True)
    print(json.dumps({"profile": profile}), flush=True)
    print(json.dumps({"interhand_serving": ih_serving}), flush=True)
    print(json.dumps({"interhand_training": ih_training}), flush=True)
    print(json.dumps({"resnet50_serving": r50_serving}), flush=True)
    for model in RESNET50_MODELS:
        print(json.dumps({"resnet50_training": r50_training[model]}),
              flush=True)
    print(json.dumps({"stems": stems}), flush=True)
    print(json.dumps({"fk_mano": fk_mano}), flush=True)
    for model in FK_MANO_MODELS:
        print(json.dumps({"fk_mano_serving": fm_serving[model]}), flush=True)
        print(json.dumps({"fk_mano_training": fm_training[model]}),
              flush=True)
    print(json.dumps({"diffusion": diffusion}), flush=True)
    print(json.dumps({"diffusion_serving": diff_serving}), flush=True)
    print(json.dumps({"diffusion_training": diff_training}), flush=True)
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
