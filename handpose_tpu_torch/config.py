"""Immutable experiment configuration (the port's own copy).

Same fields, defaults and ``--set`` override rules as
``handpose_tpu/config.py``.  The port keeps its own copy because it
imports nothing of the JAX package.  Fields that only the JAX package
reads (TPU compiler options, mesh layout, Pallas routes) stay for schema
parity; the port ignores them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

MODEL_NAMES = (
    "TwoDimHandPose",
    "TwoDimHandPoseWithFK",
    "ThreeDimHandPose",
    "OnlyThreeDimHandPose",
    "DiffusionHandPose",
    "MANO3DHandPose",
    "ThreeHandShapeAndPoseMANO",
    "Resnet50MANO3DHandPose",
    "Hand3DPoseNet",
    "Hand3DPosePriorNetwork",
)

# Loss-term gating per model (reference trainval.py:76-112).  Keys:
# xyz, uv, diffusion, hand_mask, regularization, contrastive, rot.
LOSS_GATES = {
    "TwoDimHandPose": dict(uv=True),
    "TwoDimHandPoseWithFK": dict(xyz=True, uv=True),
    "DiffusionHandPose": dict(xyz=True, diffusion=True),
    "ThreeDimHandPose": dict(xyz=True),
    "OnlyThreeDimHandPose": dict(xyz=True),
    "MANO3DHandPose": dict(xyz=True),
    "ThreeHandShapeAndPoseMANO": dict(xyz=True),
    "Resnet50MANO3DHandPose": dict(xyz=True, hand_mask=True, regularization=True),
    # Trainer-B models (reference trainval_hand3DPose.py:284-288): masked xyz
    # L2 on the canonical coords + rotation-matrix MSE.
    "Hand3DPoseNet": dict(xyz=True, rot=True),
    "Hand3DPosePriorNetwork": dict(xyz=True, rot=True),
}


@dataclass(frozen=True)
class Config:
    # -- dataset --
    dataset_root_dir: str = "/data/RHD"
    dataset_name: str = "RHD"  # 'RHD' | 'InterHand2.6M' | 'synthetic'

    # -- dataloader --
    shuffle: bool = True
    num_workers: int = 8
    use_wrist_coord: bool = True
    sigma: float = 25.0
    hand_crop: bool = True
    random_crop_to_size: bool = False
    random_crop_size: int = 256
    scale_to_size: bool = False
    scale_target_size: Tuple[int, int] = (240, 320)
    hue_aug: bool = False
    coord_uv_noise: bool = False
    crop_center_noise: bool = False
    crop_scale_noise: bool = False
    crop_offset_noise: bool = False
    scoremap_dropout: bool = False
    calculate_scoremap: bool = True
    use_val_dataset_to_debug: bool = False

    # -- network --
    model_name: str = "Hand3DPosePriorNetwork"
    input_channels: int = 24       # 3 | 21 | 24
    keypoint_num: int = 21
    resnet_out_feature_dim: int = 1024
    # train-mode BatchNorm variance: 'fast' (one-pass E[x^2]-E[x]^2),
    # 'stable' (two-pass) or 'shifted' (one pass centred on the running
    # mean).  Eval and serving do not depend on it.
    bn_variance: str = "fast"
    bn_fast_variance: bool = False
    resnet_stem: str = "k3s2"
    pool_grad: str = "native"
    compute_uv_loss: bool = False

    # -- diffusion --
    condition_feat_dim: int = 256
    num_timesteps: int = 400
    num_sampling_timesteps: int = 200
    keypoint_feat_ch: int = 1
    bone_length_num: int = 20
    other_joint_angles_num: int = 23
    diffusion_sample_in_train: bool = True
    sampler_unroll: int = 4
    sampler_hoist: str = "auto"

    # -- MANO --
    mano_right_hand_path: str = ""
    mano_pose_num: int = 10
    mano_beta_num: int = 10
    joint_order_switched: bool = True

    # -- ThreeHandShapeAndPose --
    network_regress_uv: bool = False

    # -- training --
    save_log_dir: str = "logs"
    max_epoch: int = 60
    finetune: bool = False
    batch_size: int = 200
    uv_from_xd: float = 3.0
    resume_weight_path: str | None = None
    use_fake_data: bool = False
    fast_trainval: bool = True
    lr: float = 1e-4
    lr_min: float = 1e-5
    seed: int = 0

    # -- input/output geometry --
    image_size: Tuple[int, int] = (320, 320)   # RHD raw size
    input_img_shape: Tuple[int, int] = (256, 256)
    output_hm_shape: Tuple[int, int, int] = (64, 64, 64)
    bbox_3d_size: float = 400.0
    bbox_3d_size_root: float = 400.0
    output_root_hm_shape: int = 64

    # -- InterHand schedule --
    end_epoch: int = 20
    train_batch_size: int = 200
    val_batch_size: int = 200
    test_batch_size: int = 20
    trans_test: str = "gt"
    interhand_eval_split: str = "val"

    # -- inference --
    infer_batch_size: int = 100
    infer_resume_weight_path: str | None = None

    # -- runtime --
    log_every_steps: int = 20
    fuse_preprocess: bool = True
    remat: bool = False
    # eval splits each batch into gcd(grad_accum, B) microbatches
    grad_accum: int = 1
    steps_per_dispatch: int = 8
    scoped_vmem_limit_kib: int = 65536
    cache_decoded: bool = False
    compilation_cache_dir: str = ""
    nan_check: bool = True
    debug_nans: bool = False
    profile_epoch: int = -1
    compute_dtype: str = "bfloat16"   # matmul/conv compute dtype
    param_dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    prefetch_depth: int = 2

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def crop_size(self) -> int:
        return self.input_img_shape[0]

    @property
    def bn_mode(self) -> str:
        """Resolved BatchNorm variance mode ('stable'|'fast'|'shifted'):
        the legacy bn_fast_variance=True flag upgrades 'stable'."""
        if self.bn_variance == "stable" and self.bn_fast_variance:
            return "fast"
        return self.bn_variance

    @property
    def loss_gates(self) -> dict:
        gates = dict(xyz=False, uv=False, diffusion=False, hand_mask=False,
                     regularization=False, contrastive=False, rot=False)
        gates.update(LOSS_GATES[self.model_name])
        return gates


def apply_overrides(cfg: Config, pairs) -> Config:
    """Apply ``--set key=value`` overrides, coerced to each field's type
    (tuples element-wise from the current tuple's element type)."""
    kw: dict = {}
    names = {f.name for f in dataclasses.fields(Config)}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        if key not in names:
            raise SystemExit(f"--set: unknown config field {key!r}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            kw[key] = val.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            kw[key] = int(val)
        elif isinstance(cur, float):
            kw[key] = float(val)
        elif isinstance(cur, tuple):
            elem = type(cur[0]) if cur else str
            kw[key] = tuple(elem(x) for x in val.split(","))
        else:
            kw[key] = val
    return cfg.replace(**kw)
