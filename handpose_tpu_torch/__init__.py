"""handpose_tpu_torch -- the PyTorch/CUDA port of handpose_tpu.

It keeps the JAX package's module layout and public layouts (NHWC at the
public functions), runs on an NVIDIA Hopper card, and imports nothing of
JAX or of ``handpose_tpu``.  Entry points take ``device=None``, meaning
the card; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the host.

It covers the RHD serving and training paths of
``Hand3DPosePriorNetwork``: device preprocessing with the scoremap
render as a hand-written CUDA kernel, the two ResNet-18 trunks with
train-mode BatchNorm (its moments a CUDA kernel) and the stem max pool
(its backward a CUDA kernel), Adam with the cosine LR, the fused train
and eval steps, the ``Worker``, the ``Evaluator`` and ``serve``.
"""

__version__ = "0.1.0"

from .config import Config, LOSS_GATES, MODEL_NAMES, apply_overrides
from .device import resolve_device

__all__ = ["Config", "LOSS_GATES", "MODEL_NAMES", "apply_overrides",
           "resolve_device"]
