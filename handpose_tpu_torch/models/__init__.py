"""Model zoo."""

from .zoo import (Hand3DPoseNet, Hand3DPosePriorNetwork, ModelOutput,
                   OnlyThreeDimHandPose, TwoDimHandPose, build_model)

__all__ = ["Hand3DPoseNet", "Hand3DPosePriorNetwork", "ModelOutput",
           "OnlyThreeDimHandPose", "TwoDimHandPose", "build_model"]
