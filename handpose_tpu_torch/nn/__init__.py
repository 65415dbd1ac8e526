"""Network building blocks (PyTorch modules with flax's names)."""

from .heads import (PosePrior, Pose3dPrediction, ViewPoint,
                    ViewPointPrediction)
from .layers import Conv, Dense
from .mlp import DecayMLP, decay_dims
from .norm import BN_MODES, BatchNorm, ShiftedBatchNorm, make_norm
from .resnet import (STEMS, BasicBlock, BottleneckBlock, ExtendedResNet18,
                     ExtendedResNet50, ResNet, ResNet18, ResNet34, ResNet50,
                     ResNetFeatureExtractor)

__all__ = ["PosePrior", "Pose3dPrediction", "ViewPoint",
           "ViewPointPrediction", "Conv", "Dense", "DecayMLP", "decay_dims",
           "BN_MODES", "BatchNorm", "ShiftedBatchNorm", "make_norm", "STEMS",
           "BasicBlock", "BottleneckBlock", "ExtendedResNet18",
           "ExtendedResNet50", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNetFeatureExtractor"]
