"""The trainer-B networks of the reference repository, plain.

hongrui16/3DHandPoseEstimation: ``Hand3DPosePriorNetwork`` (``network/
Hand3DPosePriorNetwork.py``, ``config.py:42``; Zimmermann & Brox, ICCV
2017, arXiv:1705.01389) puts a PosePrior and a ViewPoint head, each on
its own ResNet-18 trunk, on the 21 keypoint scoremaps; ``Hand3DPoseNet``
(``network/Hand3DPoseNet.py``) puts a Pose3d and a ViewPoint head on one
ResNet-50 trunk of the image crop, projected to ``feature_dim`` by a
float32 fc.  Both predict canonical coordinates and an axis-angle
viewpoint; the root-relative normalised pose is ``can @ R``.  Training
takes the masked L2 of the canonical coordinates plus the rotation
matrix's MSE (``trainval_hand3DPose.py:284-288``); serving scales the
pose by the root bone, adds the root and projects with the crop's
intrinsics.
"""

from __future__ import annotations

import math

import torch

from . import resnet

MODELS = ("Hand3DPosePriorNetwork", "Hand3DPoseNet")


def spec(cfg: dict) -> resnet.Spec:
    """Every leaf of ``cfg``'s network: (flax path, shape, role)."""
    c, stem = cfg["input_channels"], cfg["resnet_stem"]
    if cfg["model_name"] == "Hand3DPosePriorNetwork":
        return (resnet.trunk_spec("PosePrior_net/backbone/trunk", 18, c, stem)
                + resnet.mlp_spec("PosePrior_net/mlp", 1000, 63, 2)
                + resnet.trunk_spec("ViewPoint_net/backbone/trunk", 18, c,
                                    stem)
                + resnet.mlp_spec("ViewPoint_net/mlp", 1000, 3, 4))
    if cfg["model_name"] == "Hand3DPoseNet":
        d = cfg["resnet_out_feature_dim"]
        out = (resnet.trunk_spec("resnet_extractor/trunk", 50, c, stem)
               + resnet._dense("resnet_extractor/fc_proj", 1000, d)
               + resnet.mlp_spec("pose_predictor/mlp", d, 63, 4)
               + resnet.mlp_spec("view_point_predictor/mlp", d, 64, 4))
        for axis in "xyz":
            out += resnet._dense(f"view_point_predictor/fc_vp_u{axis}", 64, 1)
        return out
    raise ValueError(f"no reference for {cfg['model_name']!r}: {MODELS}")


def axis_angle(u: torch.Tensor) -> torch.Tensor:
    """(B, 3) axis-angle (angle |u|, with the reference's 1e-8 inside the
    norm) -> (B, 3, 3)."""
    ux, uy, uz = u.unbind(-1)
    n = torch.sqrt(ux * ux + uy * uy + uz * uz + 1e-8)
    s, c = torch.sin(n), torch.cos(n)
    x, y, z = ux / n, uy / n, uz / n
    t = 1.0 - c
    m = torch.stack([c + x * x * t, x * y * t - z * s, x * z * t + y * s,
                     y * x * t + z * s, c + y * y * t, y * z * t - x * s,
                     z * x * t - y * s, z * y * t + x * s, c + z * z * t], -1)
    return m.reshape(-1, 3, 3)


def forward(w: dict, pp: dict, cfg: dict, train: bool, quant=None) -> dict:
    """The network on preprocessed inputs -> ``can`` (B, 21, 3) and
    ``rot`` (B, 3, 3)."""
    c = cfg["input_channels"]
    if c == 21:
        x = pp["scoremap"]
    elif c == 3:
        x = pp["image_crop"].permute(0, 3, 1, 2)
    else:
        raise ValueError(f"input_channels {c} not in (3, 21)")
    B = x.shape[0]
    if cfg["model_name"] == "Hand3DPosePriorNetwork":
        can = resnet.mlp(w, "PosePrior_net/mlp", resnet.trunk(
            w, "PosePrior_net/backbone/trunk", 18, x, train, quant),
            "LeakyReLU", False)
        u = resnet.mlp(w, "ViewPoint_net/mlp", resnet.trunk(
            w, "ViewPoint_net/backbone/trunk", 18, x, train, quant),
            "LeakyReLU", False)
    else:
        feat = resnet.dense(w, "resnet_extractor/fc_proj", resnet.trunk(
            w, "resnet_extractor/trunk", 50, x, train, quant))
        can = (resnet.mlp(w, "pose_predictor/mlp", feat, "ReLU", True)
               - 0.5) * 4.0
        angles = (resnet.mlp(w, "view_point_predictor/mlp", feat, "ReLU",
                             True) - 0.5) * 2.0 * math.pi
        u = torch.cat([resnet.dense(w, f"view_point_predictor/fc_vp_u{a}",
                                    angles) for a in "xyz"], -1)
    return {"can": can.reshape(B, -1, 3), "rot": axis_angle(u[:, :3])}


def losses(out: dict, pp: dict) -> dict:
    """Masked L2 of the canonical coordinates over the visible (batch,
    joint) pairs (0 when none is visible) and the rotation's MSE."""
    v = pp["vis21"].reshape(out["can"].shape[:2]).to(torch.float32)
    sq = ((out["can"] - pp["can"]) ** 2).sum(-1)
    n = v.sum()
    xyz = torch.where(n > 0, (sq * v).sum() / n.clamp(min=1.0),
                      torch.zeros((), device=v.device))
    rot = ((out["rot"] - pp["rot"]) ** 2).mean()
    return {"loss_xyz": xyz, "loss_rot": rot, "loss": xyz + rot}


def served(out: dict, pp: dict):
    """(xyz (B, 21, 3) absolute, uv (B, 21, 2) crop pixels)."""
    xyz = (out["can"] @ out["rot"]) * pp["scale"][..., None] \
        + pp["root"][:, None]
    p = torch.einsum("bij,bnj->bni", pp["K"], xyz)
    depth = torch.where(p[..., 2] == 0, torch.full_like(p[..., 2], 1e-10),
                        p[..., 2])
    return xyz, p[..., :2] / depth[..., None]
