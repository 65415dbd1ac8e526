"""Evaluate visible-joint MPJPE over an evaluation split.

    python -m handpose_tpu_torch.infer --data_root /data/RHD \\
        --ckpt logs/<model>/RHD/run_<ts>/model_best --pck
    python -m handpose_tpu_torch.infer --dataset InterHand2.6M \\
        --data_root /data/InterHand2.6M --ckpt <run>/model_best --pck
    python -m handpose_tpu_torch.infer --model OnlyThreeDimHandPose \\
        --data_root /data/RHD

RHD reads the ``evaluation`` split, InterHand2.6M ``interhand_eval_split``
(``val``); both decode their PNGs or JPEGs per batch, or through the
decoded cache with ``--set cache_decoded=true`` (built on first use).
``--pck`` adds the PCK curve over 20-50 mm and its AUC.  ``--weights``
(alias ``--ckpt``) is a checkpoint directory the train CLI wrote, or an
``.npz`` of the JAX model's variables flattened to ``/``-joined paths
(``convert.flatten_variables``); without it the model keeps its seeded
init.  ``--model`` names the model (default: the one a checkpoint path
``logs/<model>/<dataset>/run_<ts>/<ckpt>`` names, else
Hand3DPosePriorNetwork); ``--input_channels`` defaults to the model's
convention (21 for the flagship; 24, the image and its scoremaps, for
ThreeHandShapeAndPoseMANO and Resnet50MANO3DHandPose; 3 otherwise).
The MANO models read ``MANO_RIGHT.pkl`` from ``--set
mano_right_hand_path=...``, ``$MANO_RIGHT_PKL`` or
``config/mano/models/``, else a synthetic stand-in (named on stderr).
Counterpart of the repository's ``inference.py``.
"""

from __future__ import annotations

import argparse

from ..config import (MODEL_NAMES, Config, apply_overrides,
                      default_input_channels)
from .evaluator import Evaluator, model_name_from_path


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, choices=MODEL_NAMES,
                   help="default: the model a checkpoint path names, else "
                        "Hand3DPosePriorNetwork")
    p.add_argument("--input_channels", type=int, default=None,
                   help="3 | 21 | 24 (default: the model's convention)")
    p.add_argument("--dataset", default="RHD",
                   choices=["RHD", "InterHand2.6M", "synthetic"])
    p.add_argument("--data_root", default="/data/RHD")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--weights", "--ckpt", dest="weights", default=None,
                   metavar="NPZ_OR_DIR")
    p.add_argument("--pck", action="store_true",
                   help="also report the PCK curve and the 20-50 mm AUC")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override any Config field, e.g. --set sigma=10")
    args = p.parse_args(argv)
    model = args.model
    if model is None and args.weights:
        model = model_name_from_path(args.weights)
    if model not in MODEL_NAMES:
        # no --model and no run directory's checkpoint (e.g. an .npz)
        model = "Hand3DPosePriorNetwork"
    channels = args.input_channels
    if channels is None:
        channels = default_input_channels(model)
    cfg = Config(model_name=model, input_channels=channels,
                 dataset_name=args.dataset, dataset_root_dir=args.data_root,
                 infer_batch_size=args.batch_size)
    cfg = apply_overrides(cfg, args.overrides)
    ev = Evaluator(cfg, weights=args.weights, device=args.device)
    if not args.pck:
        mpjpe = ev.evaluate(max_batches=args.max_batches)
        print(f"visible-joint MPJPE: {mpjpe:.5f} mm")
        return mpjpe
    res = ev.evaluate_full(max_batches=args.max_batches)
    print(f"visible-joint MPJPE: {res['mpjpe']:.5f} mm")
    print(f"AUC (20-50mm): {res['auc_20_50mm']:.4f}")
    for t, v in zip(res["pck_thresholds"][::6], res["pck"][::6]):
        print(f"  PCK@{t * 1000:.0f}mm: {v:.4f}")
    return res


if __name__ == "__main__":
    main()
