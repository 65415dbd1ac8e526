"""Network building blocks (PyTorch modules with flax's names)."""

from .fk import JOINT_SWITCH_PERM, fk_positions, forward_kinematics
from .heads import (BoneAnglePrediction, BoneLengthPrediction,
                    MANOBetasPrediction, MANOThetaPrediction, PosePrior,
                    Pose3dPrediction, ViewPoint, ViewPointPrediction)
from .layers import Conv, Dense
from .mano import (ManoLayer, ManoModel, find_mano_pkl, load_mano,
                   mano_source, synthetic_mano)
from .mlp import DecayMLP, decay_dims
from .norm import BN_MODES, BatchNorm, ShiftedBatchNorm, make_norm
from .resnet import (STEMS, BasicBlock, BottleneckBlock, ExtendedResNet18,
                     ExtendedResNet50, ResNet, ResNet18, ResNet34, ResNet50,
                     ResNetFeatureExtractor, ResNetMano)

__all__ = ["JOINT_SWITCH_PERM", "fk_positions", "forward_kinematics",
           "BoneAnglePrediction", "BoneLengthPrediction",
           "MANOBetasPrediction", "MANOThetaPrediction", "PosePrior",
           "Pose3dPrediction", "ViewPoint", "ViewPointPrediction", "Conv",
           "Dense", "ManoLayer", "ManoModel", "find_mano_pkl", "load_mano",
           "mano_source", "synthetic_mano", "DecayMLP", "decay_dims", "BN_MODES",
           "BatchNorm", "ShiftedBatchNorm", "make_norm", "STEMS",
           "BasicBlock", "BottleneckBlock", "ExtendedResNet18",
           "ExtendedResNet50", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNetFeatureExtractor", "ResNetMano"]
