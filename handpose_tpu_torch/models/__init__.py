"""Model zoo."""

from .zoo import (DiffusionHandPose, Hand3DPoseNet, Hand3DPosePriorNetwork, MANO3DHandPose,
                  ModelOutput, OnlyThreeDimHandPose, Resnet50MANO3DHandPose,
                  ThreeDimHandPose, ThreeHandShapeAndPoseMANO, TwoDimHandPose,
                  TwoDimHandPoseWithFK, build_model, hook_geometry_inputs,
                  mano_source_of)

__all__ = ["DiffusionHandPose", "Hand3DPoseNet", "Hand3DPosePriorNetwork", "MANO3DHandPose",
           "ModelOutput", "OnlyThreeDimHandPose", "Resnet50MANO3DHandPose",
           "ThreeDimHandPose", "ThreeHandShapeAndPoseMANO", "TwoDimHandPose",
           "TwoDimHandPoseWithFK", "build_model", "hook_geometry_inputs",
           "mano_source_of"]
