"""Network building blocks (PyTorch modules with flax's names)."""

from .heads import PosePrior, ViewPoint
from .layers import Conv, Dense
from .mlp import DecayMLP, decay_dims
from .norm import BatchNorm
from .resnet import BasicBlock, ExtendedResNet18, ResNet, ResNet18

__all__ = ["PosePrior", "ViewPoint", "Conv", "Dense", "DecayMLP",
           "decay_dims", "BatchNorm", "BasicBlock", "ExtendedResNet18",
           "ResNet", "ResNet18"]
