"""ResNet-stem max pool, forward only.

Port of the forward of ``handpose_tpu/ops/pooling.py:169-206`` (the
'native' route): 3x3 window, stride 2, one pixel of -inf padding on each
side, which is what ``F.max_pool2d(x, 3, 2, 1)`` computes.  The JAX
package's gradient routes ('argmax', 'pallas') are backward passes and
wait for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stem_max_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, ceil(H/2), ceil(W/2))."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
