"""handpose_tpu_torch -- the PyTorch/CUDA port of handpose_tpu.

It keeps the JAX package's module layout and public layouts (NHWC at the
public functions), runs on an NVIDIA Hopper card, and imports nothing of
JAX or of ``handpose_tpu``.  Entry points take ``device=None``, meaning
the card; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the host.

This slice covers the RHD serving path of ``Hand3DPosePriorNetwork``:
device preprocessing with the scoremap render as a hand-written CUDA
kernel, the two ResNet-18 trunks in eval mode, the eval metrics, the
``Evaluator`` and ``serve``.
"""

__version__ = "0.1.0"

from .config import Config, LOSS_GATES, MODEL_NAMES, apply_overrides
from .device import resolve_device

__all__ = ["Config", "LOSS_GATES", "MODEL_NAMES", "apply_overrides",
           "resolve_device"]
