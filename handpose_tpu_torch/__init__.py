"""handpose_tpu_torch -- the PyTorch/CUDA port of handpose_tpu.

It keeps the JAX package's module layout and public layouts (NHWC at the
public functions), runs on an NVIDIA Hopper card, and imports nothing of
JAX or of ``handpose_tpu``.  Entry points take ``device=None``, meaning
the card; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the host.

It covers the RHD and InterHand2.6M serving and training paths of
``Hand3DPosePriorNetwork``: its own PNG and JPEG codecs with the decoded
caches (``csrc/imageio.cpp``), device preprocessing with the scoremap
render as a hand-written CUDA kernel, the two ResNet-18 trunks with
train-mode BatchNorm (its moments a CUDA kernel) and the stem max pool
(its backward a CUDA kernel), Adam with the cosine LR, the fused train
and eval steps with the train-time augmentations, the ``Worker`` with
checkpoints, resume, preemption, run logging and fake data, the
``Evaluator`` with MPJPE, PCK and AUC, and ``serve``.  The ResNet-50
family (``TwoDimHandPose``, ``OnlyThreeDimHandPose``, ``Hand3DPoseNet``)
with the three stems and the trainer-A losses runs through the same
harness.
"""

__version__ = "0.1.0"

from .config import Config, LOSS_GATES, MODEL_NAMES, apply_overrides
from .device import resolve_device

__all__ = ["Config", "LOSS_GATES", "MODEL_NAMES", "apply_overrides",
           "resolve_device"]
