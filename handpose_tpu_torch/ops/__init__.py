"""Geometry, rendering and patch ops and the port's kernel wrappers
(PyTorch, batch-first).

Exports every name ``handpose_tpu/ops/__init__.py`` exports, plus the
scoremap kernel's wrapper and the stem max pool.  Importing this package
registers the operators of the scoremap kernel
(``torch.ops.handpose_tpu_torch.render_gaussian_maps``) and of eval-mode
BatchNorm (``torch.ops.handpose_tpu_torch.bn_eval_apply``), which is all
a process needs to load an exported serving program.
"""

from . import bn_apply_cuda  # noqa: F401  (registers its operator)
from .bone_rel import bone_rel_trafo, bone_rel_trafo_inv
from .camera import cam2pixel, pixel2cam, world2cam
from .canonical import canonical_trafo, flip_right_hand
from .crop import (CropParams, compute_crop_params, crop_intrinsics,
                   crop_resize_bilinear, crop_resize_nearest, crop_uv)
from .heatmap import render_gaussian_heatmap_3d, render_gaussian_maps
from .patch import (affine_warp_bilinear, gen_trans_from_patch, get_aug_config,
                    get_bbox, process_bbox, trans_point2d,
                    transform_input_to_output_space)
from .pooling import stem_max_pool
from .projection import (absolute_to_rel_normed, batch_project_xyz_to_uv,
                         camera_xyz_to_uv, rel_normed_to_absolute)
from .rotations import (atan2_safe, axis_angle_rot_mat, euler_xyz_rot_mat,
                        rodrigues, rot_mat_x, rot_mat_y, rot_mat_z)
from .scoremap_cuda import render_gaussian_maps_cuda

__all__ = [
    "atan2_safe", "rot_mat_x", "rot_mat_y", "rot_mat_z",
    "euler_xyz_rot_mat", "axis_angle_rot_mat", "rodrigues",
    "canonical_trafo", "flip_right_hand",
    "bone_rel_trafo", "bone_rel_trafo_inv",
    "camera_xyz_to_uv", "batch_project_xyz_to_uv",
    "rel_normed_to_absolute", "absolute_to_rel_normed",
    "render_gaussian_maps", "render_gaussian_heatmap_3d",
    "CropParams", "compute_crop_params", "crop_resize_bilinear",
    "crop_resize_nearest", "crop_intrinsics", "crop_uv",
    "world2cam", "cam2pixel", "pixel2cam",
    "get_bbox", "process_bbox", "gen_trans_from_patch",
    "affine_warp_bilinear", "transform_input_to_output_space",
    "get_aug_config", "trans_point2d",
    "render_gaussian_maps_cuda", "stem_max_pool",
]
