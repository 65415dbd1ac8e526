"""Train Hand3DPosePriorNetwork on an RHD tree with the port.

    python -m handpose_tpu_torch.train --data_root /data/RHD \\
        --batch_size 256 --max_epoch 60 --device cuda

The splits must hold the decoded uint8 cache (see ``data/rhd.py``).
``--weights`` starts from an ``.npz`` of the JAX model's variables
flattened to ``/``-joined paths (``convert.flatten_variables``); without
it the model starts from its seeded init.  Counterpart of the
repository's ``trainval.py`` for the flags this slice covers; prints the
best validation MPJPE.
"""

from __future__ import annotations

import argparse

from ..config import MODEL_NAMES, Config, apply_overrides
from ..models.zoo import _WAITING, _ZOO
from .trainer import Worker


def main(argv=None) -> float:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="Hand3DPosePriorNetwork",
                   choices=MODEL_NAMES)
    p.add_argument("--data_root", default="/data/RHD")
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--max_epoch", type=int, default=60)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fast_debug", action="store_true",
                   help="stop every epoch after 3 iterations")
    p.add_argument("--use_val_to_debug", action="store_true",
                   help="train on the evaluation split")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--weights", default=None, metavar="NPZ")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override any Config field, e.g. --set sigma=10")
    args = p.parse_args(argv)
    if args.model not in _ZOO:
        p.error(f"{args.model} is not ported yet; it waits in ROADMAP.md "
                f"queue 1 ({_WAITING[args.model]})")
    cfg = Config(model_name=args.model, input_channels=21,
                 dataset_name="RHD", dataset_root_dir=args.data_root,
                 batch_size=args.batch_size, max_epoch=args.max_epoch,
                 lr=args.lr, use_val_dataset_to_debug=args.use_val_to_debug,
                 save_log_dir=args.log_dir, seed=args.seed)
    cfg = apply_overrides(cfg, args.overrides)
    worker = Worker(cfg, weights=args.weights, device=args.device)
    best = worker.run(fast_debug=args.fast_debug)
    print(f"best val MPJPE: {best:.5f}")
    return best


if __name__ == "__main__":
    main()
