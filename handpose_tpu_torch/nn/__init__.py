"""Network building blocks (PyTorch modules with flax's names)."""

from .heads import PosePrior, ViewPoint
from .layers import Conv, Dense
from .mlp import DecayMLP, decay_dims
from .norm import BN_MODES, BatchNorm, ShiftedBatchNorm, make_norm
from .resnet import BasicBlock, ExtendedResNet18, ResNet, ResNet18

__all__ = ["PosePrior", "ViewPoint", "Conv", "Dense", "DecayMLP",
           "decay_dims", "BN_MODES", "BatchNorm", "ShiftedBatchNorm",
           "make_norm", "BasicBlock", "ExtendedResNet18", "ResNet",
           "ResNet18"]
