"""Evaluate visible-joint MPJPE over an evaluation split, draw overlays,
or export the serving forward.

    python -m handpose_tpu_torch.infer --data_root /data/RHD \\
        --ckpt logs/<model>/RHD/run_<ts>/model_best --pck
    python -m handpose_tpu_torch.infer --from_run logs/<model>/RHD/run_<ts> \\
        --data_root /data/RHD --visualize_dir /tmp/vis
    python -m handpose_tpu_torch.infer --dataset InterHand2.6M \\
        --data_root /data/InterHand2.6M --ckpt <run>/model_best --pck
    python -m handpose_tpu_torch.infer --from_run <run> --export hand.pt2

RHD reads the ``evaluation`` split, InterHand2.6M ``interhand_eval_split``
(``val``); both decode their PNGs or JPEGs per batch, or through the
decoded cache with ``--set cache_decoded=true`` (built on first use).
``--pck`` adds the PCK curve over 20-50 mm and its AUC.  ``--weights``
(alias ``--ckpt``) is a checkpoint directory the train CLI wrote, or an
``.npz`` of the JAX model's variables flattened to ``/``-joined paths
(``convert.flatten_variables``); without it the model keeps its seeded
init.  ``--from_run`` takes the whole Config from a run's
``config.json`` and its weights from ``model_best/``, else
``checkpoint/`` (it exits when the run has neither); the dataset flags
given explicitly, then ``--set``, apply on top.  ``--model`` names the
model (default: the one a checkpoint path
``logs/<model>/<dataset>/run_<ts>/<ckpt>`` names, else
Hand3DPosePriorNetwork); ``--input_channels`` defaults to the model's
convention (21 for the flagship; 24, the image and its scoremaps, for
ThreeHandShapeAndPoseMANO and Resnet50MANO3DHandPose; 3 otherwise).
``--visualize_dir`` writes the first batch's first ``--visualize_n``
crops with the ground truth (green) and the prediction (red) to
``<dir>/img/000_<i>_pre.jpg``.  ``--export PATH`` writes the model's
inference forward, weights included, as a ``torch.export`` artifact at
batch ``--export_batch`` (``infer/export.py``) and exits.  The MANO
models read ``MANO_RIGHT.pkl`` from ``--set mano_right_hand_path=...``,
``$MANO_RIGHT_PKL`` or ``config/mano/models/``, else a synthetic
stand-in (named on stderr).  Counterpart of the repository's
``inference.py``.
"""

from __future__ import annotations

import argparse
import os

from ..config import (MODEL_NAMES, Config, apply_overrides,
                      default_input_channels)
from .evaluator import Evaluator, model_name_from_path


def _from_run(args):
    """(the run's Config with the explicitly given dataset flags on top,
    the weights) (``inference.py:56-90``): None means not given, so even
    a value equal to the usual default counts."""
    with open(os.path.join(args.from_run, "config.json")) as f:
        cfg = Config.from_json(f.read())
    weights = args.weights
    if weights is None:
        for name in ("model_best", "checkpoint"):
            cand = os.path.join(args.from_run, name)
            if os.path.isdir(cand):
                weights = cand
                break
        else:
            # never evaluate random weights in a run's name
            raise SystemExit(f"--from_run: no model_best/ or checkpoint/ "
                             f"under {args.from_run}; pass --ckpt")
    explicit = {field: getattr(args, flag) for flag, field in (
        ("data_root", "dataset_root_dir"), ("dataset", "dataset_name"),
        ("batch_size", "infer_batch_size")) if getattr(args, flag) is not None}
    return cfg.replace(infer_resume_weight_path=weights, **explicit), weights


def _new_config(args):
    model = args.model
    if model is None and args.weights:
        model = model_name_from_path(args.weights)
    if model not in MODEL_NAMES:
        # no --model and no run directory's checkpoint (e.g. an .npz)
        model = "Hand3DPosePriorNetwork"
    channels = args.input_channels
    if channels is None:
        channels = default_input_channels(model)
    cfg = Config(
        model_name=model, input_channels=channels,
        dataset_name=args.dataset if args.dataset is not None else "RHD",
        dataset_root_dir=(args.data_root if args.data_root is not None
                          else "/data/RHD"),
        infer_batch_size=(args.batch_size if args.batch_size is not None
                          else 100))
    return cfg, args.weights


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, choices=MODEL_NAMES,
                   help="default: the model a checkpoint path names, else "
                        "Hand3DPosePriorNetwork")
    p.add_argument("--input_channels", type=int, default=None,
                   help="3 | 21 | 24 (default: the model's convention)")
    # dataset flags default to None, so that "given" is detectable for
    # --from_run; the defaults are in _new_config
    p.add_argument("--dataset", default=None,
                   choices=["RHD", "InterHand2.6M", "synthetic"],
                   help="default RHD")
    p.add_argument("--data_root", default=None, help="default /data/RHD")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default 100")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--weights", "--ckpt", dest="weights", default=None,
                   metavar="NPZ_OR_DIR")
    p.add_argument("--from_run", default=None, metavar="RUN_DIR",
                   help="the whole Config from RUN_DIR/config.json; the "
                        "weights default to RUN_DIR/model_best, then "
                        "RUN_DIR/checkpoint")
    p.add_argument("--pck", action="store_true",
                   help="also report the PCK curve and the 20-50 mm AUC")
    p.add_argument("--visualize_dir", default=None,
                   help="write overlays of the first batch here")
    p.add_argument("--visualize_n", type=int, default=8)
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write the model's inference forward (weights "
                        "included) as a torch.export artifact and exit")
    p.add_argument("--export_batch", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override any Config field, e.g. --set sigma=10")
    args = p.parse_args(argv)
    cfg, weights = _from_run(args) if args.from_run else _new_config(args)
    cfg = apply_overrides(cfg, args.overrides)
    if args.export:
        from .export import export_forward, save_exported
        blob = export_forward(cfg, weights, args.export_batch, args.device)
        save_exported(args.export, blob)
        print(f"exported {len(blob)} bytes to {args.export}")
        return args.export
    ev = Evaluator(cfg, weights=weights, device=args.device,
                   visualize_dir=args.visualize_dir)
    if not args.pck:
        mpjpe = ev.evaluate(max_batches=args.max_batches,
                            visualize_first_n=args.visualize_n
                            if args.visualize_dir else 0)
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
