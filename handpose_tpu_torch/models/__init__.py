"""Model zoo."""

from .zoo import Hand3DPosePriorNetwork, ModelOutput, build_model

__all__ = ["Hand3DPosePriorNetwork", "ModelOutput", "build_model"]
