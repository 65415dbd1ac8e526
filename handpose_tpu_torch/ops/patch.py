"""InterHand bbox helpers, host-side numpy.

Port of ``get_bbox`` and ``process_bbox`` of ``handpose_tpu/ops/patch.py:
26-53`` (reference utils/preprocessing.py:122-155).  They run once per
annotation while the dataset parses its json.  ``process_bbox`` works in
numpy float32 scalars in the JAX function's order of operations, so the
bboxes are bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_bbox(joint_img: np.ndarray, joint_valid: np.ndarray) -> np.ndarray:
    """(x, y, w, h) around the valid joints, widened by 1.2."""
    x = joint_img[:, 0][joint_valid == 1]
    y = joint_img[:, 1][joint_valid == 1]
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    xc, w = (xmin + xmax) / 2.0, xmax - xmin
    yc, h = (ymin + ymax) / 2.0, ymax - ymin
    return np.array([xc - 0.6 * w, yc - 0.6 * h, 1.2 * w, 1.2 * h],
                    np.float32)


def process_bbox(bbox: np.ndarray,
                 original_img_shape: Tuple[int, int],
                 input_img_shape: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """The bbox brought to the input's aspect ratio about its centre, then
    widened by 1.25 (``original_img_shape`` is unused, as in the
    reference)."""
    bbox = np.asarray(bbox, np.float32).copy()
    w, h = bbox[2], bbox[3]
    c_x = bbox[0] + w / 2.0
    c_y = bbox[1] + h / 2.0
    aspect = input_img_shape[1] / input_img_shape[0]
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    bbox[2] = w * 1.25
    bbox[3] = h * 1.25
    bbox[0] = c_x - bbox[2] / 2.0
    bbox[1] = c_y - bbox[3] / 2.0
    return bbox
