"""Train a model of the port's zoo (default Hand3DPosePriorNetwork).

    python -m handpose_tpu_torch.train --data_root /data/RHD \\
        --batch_size 256 --max_epoch 60 --device cuda
    python -m handpose_tpu_torch.train --dataset InterHand2.6M \\
        --data_root /data/InterHand2.6M --batch_size 256 \\
        --set cache_decoded=true
    python -m handpose_tpu_torch.train --fake_data --fast_debug
    python -m handpose_tpu_torch.train --model OnlyThreeDimHandPose \\
        --data_root /data/RHD --batch_size 256
    python -m handpose_tpu_torch.train --model Resnet50MANO3DHandPose \\
        --data_root /data/RHD --set mano_right_hand_path=MANO_RIGHT.pkl
    python -m handpose_tpu_torch.train --from_run <run_dir> \\
        --resume <run_dir>/checkpoint

Counterpart of the repository's ``trainval.py`` for the flags the port
covers.  The datasets decode their PNGs (RHD) or JPEGs (InterHand2.6M)
per batch, or once into a decoded cache with ``--set
cache_decoded=true``.  ``--weights`` starts from an ``.npz`` of flattened
flax variables (``convert.flatten_variables``) or a checkpoint
directory; ``--resume`` resumes (same architecture: optimizer, epoch and
best MPJPE too) or finetunes (matching params only) from a checkpoint
directory; ``--from_run`` takes the whole Config from a run's
``config.json``, and the dataset and path flags given explicitly, then
``--resume``, ``--set`` and ``--log_dir``, apply on top.  SIGTERM writes
a checkpoint at the next step boundary and exits; resuming from it
restarts the interrupted epoch.  The MANO models read ``MANO_RIGHT.pkl``
from ``--set mano_right_hand_path=...``, ``$MANO_RIGHT_PKL`` or
``config/mano/models/``, else a synthetic stand-in (named on stderr).
Prints the best validation MPJPE.
"""

from __future__ import annotations

import argparse
import os

from ..config import (MODEL_NAMES, Config, apply_overrides,
                      default_input_channels)
from .trainer import Worker


def _from_run(args) -> Config:
    """The run's Config with the explicitly given flags on top
    (``trainval.py:58-88``): None means not given, so even a value equal
    to the usual default counts."""
    with open(os.path.join(args.from_run, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if args.resume:
        cfg = cfg.replace(resume_weight_path=args.resume)
    explicit = {field: getattr(args, flag) for flag, field in (
        ("data_root", "dataset_root_dir"), ("dataset", "dataset_name"),
        ("batch_size", "batch_size"), ("max_epoch", "max_epoch"),
        ("log_dir", "save_log_dir")) if getattr(args, flag) is not None}
    if args.use_val_to_debug:
        explicit["use_val_dataset_to_debug"] = True
    if args.fake_data:
        explicit["use_fake_data"] = True
    return cfg.replace(**explicit)


def _new_config(args) -> Config:
    def given(v, default):
        return default if v is None else v

    return Config(
        model_name=args.model,
        dataset_name="synthetic" if args.fake_data
        else given(args.dataset, "RHD"),
        dataset_root_dir=given(args.data_root, "/data/RHD"),
        batch_size=given(args.batch_size, 200),
        input_channels=given(args.input_channels,
                             default_input_channels(args.model)),
        max_epoch=given(args.max_epoch, 60), lr=args.lr,
        use_fake_data=args.fake_data,
        use_val_dataset_to_debug=args.use_val_to_debug,
        resume_weight_path=args.resume,
        save_log_dir=given(args.log_dir, "logs"), seed=args.seed)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="Hand3DPosePriorNetwork",
                   choices=MODEL_NAMES)
    # dataset and path flags default to None, so that "given" is
    # detectable for --from_run; the defaults are in _new_config
    p.add_argument("--dataset", default=None,
                   choices=["RHD", "InterHand2.6M", "synthetic"],
                   help="default RHD")
    p.add_argument("--data_root", default=None, help="default /data/RHD")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default 200")
    p.add_argument("--input_channels", type=int, default=None,
                   help="3 | 21 | 24 (default: the model's convention)")
    p.add_argument("--max_epoch", type=int, default=None, help="default 60")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fast_debug", action="store_true",
                   help="stop every epoch after 3 iterations")
    p.add_argument("--fake_data", action="store_true",
                   help="synthetic half-bright image and fixed pose, no "
                        "dataset")
    p.add_argument("--use_val_to_debug", action="store_true",
                   help="train on the evaluation split")
    p.add_argument("--resume", default=None, metavar="CKPT_DIR")
    p.add_argument("--from_run", default=None, metavar="RUN_DIR",
                   help="the whole Config from RUN_DIR/config.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", default=None, help="default logs")
    p.add_argument("--weights", default=None, metavar="NPZ_OR_DIR")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override any Config field, e.g. --set sigma=10")
    args = p.parse_args(argv)
    cfg = _from_run(args) if args.from_run else _new_config(args)
    cfg = apply_overrides(cfg, args.overrides)
    worker = Worker(cfg, weights=args.weights, device=args.device)
    # SIGTERM (preemption) -> a checkpoint at the next step boundary and a
    # clean exit; resuming restarts the interrupted epoch
    worker.enable_preemption_save()
    best = worker.run(fast_debug=args.fast_debug)
    print(f"best val MPJPE: {best:.5f}")
    return best


if __name__ == "__main__":
    main()
