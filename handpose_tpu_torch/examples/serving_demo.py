"""Serving demo: weights -> a torch.export artifact -> standalone predict.

    python -m handpose_tpu_torch.examples.serving_demo --fresh
    python -m handpose_tpu_torch.examples.serving_demo \\
        --from_run logs/<model>/<dataset>/run_<ts> --out hand.pt2
    python -m handpose_tpu_torch.examples.serving_demo --fresh --fused

Port of ``examples/serving_demo.py``:

1. the weights of a trained run (``model_best/``, else ``checkpoint/``)
   or, with ``--fresh``, the seeded init of a small OnlyThreeDimHandPose;
2. the inference forward exported with those weights as one
   ``torch.export`` artifact (``--fused``: the whole RHD serving program,
   raw uint8 sample in, preprocessing with the scoremap kernel, forward);
3. the artifact loaded back through ``infer.export``'s loader, which
   imports only ``handpose_tpu_torch.ops`` (no model zoo, config or
   checkpoint code), and a prediction on a batch.

A checkpoint that only partly matches the run's model is refused: part of
the exported weights would be the init.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

RAW_FIELDS = ("image", "mask", "keypoint_uv", "keypoint_vis",
              "keypoint_xyz", "camera_K")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--from_run", default=None,
                    help="run dir with config.json and model_best/ or "
                         "checkpoint/")
    ap.add_argument("--fresh", action="store_true",
                    help="the seeded init of a small model instead of a run")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "handpose_forward.pt2"))
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--fused", action="store_true",
                    help="export the fused raw -> preprocess -> forward "
                         "pipeline (RHD-format raw inputs) instead of the "
                         "model forward alone")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..data.preprocess import model_input
    from ..data.synthetic import fake_sample_batch
    from ..infer.export import (export_forward, export_fused_pipeline,
                                load_exported_file, save_exported)
    from ..train.checkpoints import load_variables

    if args.fresh:
        cfg = Config(model_name="OnlyThreeDimHandPose", input_channels=3,
                     input_img_shape=(128, 128), resnet_out_feature_dim=256)
        weights = None
    elif args.from_run:
        with open(os.path.join(args.from_run, "config.json")) as f:
            cfg = Config.from_json(f.read())
        for name in ("model_best", "checkpoint"):
            cand = os.path.join(args.from_run, name)
            if os.path.isdir(cand):
                weights = load_variables(cand)
                break
        else:
            ap.error(f"no model_best/ or checkpoint/ under {args.from_run}")
    else:
        ap.error("pass --fresh or --from_run <dir>")

    B = args.batch_size
    try:
        if args.fused:
            from ..data.rhd import RHDDataset, write_synthetic_rhd
            root = os.path.join(tempfile.gettempdir(),
                                "hpt_torch_serving_demo_rhd")
            if not os.path.exists(os.path.join(
                    root, "evaluation", "anno_evaluation.pickle")):
                write_synthetic_rhd(root, "evaluation", n=max(8, B))
            raw = RHDDataset(root, "evaluation").raw_batch(list(range(B)))
            blob = export_fused_pipeline(cfg, weights, B,
                                         tuple(raw.image.shape[1:3]),
                                         args.device)
        else:
            blob = export_forward(cfg, weights, B, args.device)
    except (KeyError, ValueError) as e:
        # a partial key match would export part of the weights as init
        ap.error(f"the checkpoint does not match the model built from "
                 f"{args.from_run}/config.json ({e}); refusing to export "
                 "partially initialised weights")
    save_exported(args.out, blob)
    what = "fused pipeline" if args.fused else "forward"
    print(f"exported {what} {len(blob) / 1e6:.1f} MB -> {args.out}")

    # a serving process: the artifact file and tensors
    fn = load_exported_file(args.out)
    if args.fused:
        xyz, uv = fn(*(np.asarray(getattr(raw, k)) for k in RAW_FIELDS))
    else:
        batch = fake_sample_batch(B, cfg.crop_size, cfg.input_channels,
                                  seed=1)
        xyz, uv = fn(model_input(batch, cfg.input_channels),
                     batch["camera_intrinsic_matrix"],
                     batch["keypoint_scale"], batch["keypoint_xyz_root"])
    print("xyz", tuple(xyz.shape), "uv", tuple(uv.shape),
          "| first joint:", xyz[0, 0].cpu().numpy())
    return xyz, uv


if __name__ == "__main__":
    main()
