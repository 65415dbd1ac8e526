"""Evaluate visible-joint MPJPE over the RHD evaluation split.

    python -m handpose_tpu_torch.infer --data_root /data/RHD \\
        --ckpt logs/<model>/RHD/run_<ts>/model_best --device cuda

The split must hold the decoded uint8 cache (see ``data/rhd.py``).
``--weights`` (alias ``--ckpt``) is a checkpoint directory the train CLI
wrote, or an ``.npz`` of the JAX model's variables flattened to
``/``-joined paths (``convert.flatten_variables``); without it the model
keeps its seeded init.  Counterpart of the repository's ``inference.py``.
"""

from __future__ import annotations

import argparse

from ..config import Config, apply_overrides
from .evaluator import Evaluator


def main(argv=None) -> float:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default="/data/RHD")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--weights", "--ckpt", dest="weights", default=None,
                   metavar="NPZ_OR_DIR")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   dest="overrides",
                   help="override any Config field, e.g. --set sigma=10")
    args = p.parse_args(argv)
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_name="RHD", dataset_root_dir=args.data_root,
                 infer_batch_size=args.batch_size)
    cfg = apply_overrides(cfg, args.overrides)
    ev = Evaluator(cfg, weights=args.weights, device=args.device)
    mpjpe = ev.evaluate(max_batches=args.max_batches)
    print(f"visible-joint MPJPE: {mpjpe:.5f} mm")
    return mpjpe


if __name__ == "__main__":
    main()
