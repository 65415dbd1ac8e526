"""Geometry ops and the scoremap kernel (PyTorch, batch-first)."""

from .bone_rel import bone_rel_trafo
from .canonical import canonical_trafo
from .crop import (CropParams, compute_crop_params, crop_intrinsics,
                   crop_resize_bilinear, crop_resize_nearest, crop_uv)
from .heatmap import render_gaussian_maps
from .pooling import stem_max_pool
from .projection import batch_project_xyz_to_uv, rel_normed_to_absolute
from .rotations import (atan2_safe, axis_angle_rot_mat, euler_xyz_rot_mat,
                        rodrigues, rot_mat_x, rot_mat_y, rot_mat_z)
from .scoremap_cuda import render_gaussian_maps_cuda

__all__ = [
    "atan2_safe", "rot_mat_x", "rot_mat_y", "rot_mat_z", "axis_angle_rot_mat",
    "euler_xyz_rot_mat", "rodrigues",
    "canonical_trafo", "bone_rel_trafo",
    "batch_project_xyz_to_uv", "rel_normed_to_absolute",
    "render_gaussian_maps", "render_gaussian_maps_cuda",
    "CropParams", "compute_crop_params", "crop_resize_bilinear",
    "crop_resize_nearest", "crop_intrinsics", "crop_uv",
    "stem_max_pool",
]
