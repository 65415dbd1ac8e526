"""Batched differentiable MANO hand layer.

Port of ``handpose_tpu/nn/mano.py`` (reference
network/sub_modules/MANOLayer.py:51-240): linear blend skinning as
einsums, the 16-joint kintree unrolled over ``parents``, Rodrigues with
its small-angle branch, and the five fingertip mesh vertices
(333/444/672/555/745) inserted to reach 21 joints.

The MANO_RIGHT.pkl asset (a licensed MPI file) is not bundled.
:func:`load_mano` reads it from an explicit path (which must exist), else
``$MANO_RIGHT_PKL`` or the repo-relative
``config/mano/models/MANO_RIGHT.pkl``, and falls back to
:func:`synthetic_mano`, a seeded stand-in with MANO's shapes (the
JAX package's, bit for bit).  The pickle embeds chumpy objects; a stub
unpickler turns them into numpy without the chumpy package.
"""

from __future__ import annotations

import os
import pickle
import sys
import types
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.rotations import rodrigues

_SEARCH_PATHS = ("config/mano/models/MANO_RIGHT.pkl",)


class _FakeCh:
    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    def __array__(self, dtype=None, copy=None):
        x = np.asarray(self.__dict__.get("x"))
        return x.astype(dtype) if dtype is not None else x


class _FakeSelect(_FakeCh):
    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.__dict__["a"])
        x = a.ravel()[np.asarray(self.__dict__["idxs"])]
        shape = self.__dict__.get("preferred_shape")
        if shape is not None:
            x = x.reshape(shape)
        return x.astype(dtype) if dtype is not None else x


def _ensure_chumpy_stub():
    if "chumpy" in sys.modules:
        return
    pkg = types.ModuleType("chumpy")
    pkg.__path__ = []
    pkg.Ch = _FakeCh
    ch = types.ModuleType("chumpy.ch")
    ch.Ch = _FakeCh
    reo = types.ModuleType("chumpy.reordering")
    reo.Select = _FakeSelect
    sys.modules["chumpy"] = pkg
    sys.modules["chumpy.ch"] = ch
    sys.modules["chumpy.reordering"] = reo


def find_mano_pkl(path: str | None = None) -> str | None:
    """``path`` if given, else the first of ``$MANO_RIGHT_PKL`` and the
    repo-relative search paths that exists, or None.  A ``path`` that
    does not exist raises: a mistyped path would otherwise train on the
    stand-in's random geometry."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"MANO pickle {path!r} does not exist")
        return path
    candidates = []
    if os.environ.get("MANO_RIGHT_PKL"):
        candidates.append(os.environ["MANO_RIGHT_PKL"])
    candidates.extend(_SEARCH_PATHS)
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class ManoModel(NamedTuple):
    """MANO's constants (numpy)."""

    v_template: np.ndarray       # (778, 3)
    shapedirs: np.ndarray        # (778, 3, 10)
    posedirs: np.ndarray         # (778, 3, 135)
    J_regressor: np.ndarray      # (16, 778) densified
    weights: np.ndarray          # (778, 16)
    hands_components: np.ndarray  # (45, 45)
    hands_mean: np.ndarray       # (45,)
    parents: tuple               # len 16, parents[0] == -1
    faces: np.ndarray            # (1538, 3)


SYNTHETIC = "synthetic stand-in (no MANO_RIGHT.pkl found)"


def mano_source(path: str | None = None) -> str:
    """What :func:`load_mano` of ``path`` loads: the pickle's absolute
    path, or :data:`SYNTHETIC`."""
    found = find_mano_pkl(path)
    return os.path.abspath(found) if found else SYNTHETIC


_ANNOUNCED: set = set()


def _announce(source: str) -> None:
    """Name on stderr, once a process, each MANO that is loaded."""
    if source not in _ANNOUNCED:
        _ANNOUNCED.add(source)
        print(f"MANO: {source}", file=sys.stderr, flush=True)


def load_mano(path: str | None = None) -> ManoModel:
    """MANO from the pickle :func:`find_mano_pkl` finds, else the
    synthetic stand-in; names on stderr which."""
    resolved = mano_source(path)
    _announce(resolved)
    if resolved == SYNTHETIC:
        return synthetic_mano()
    _ensure_chumpy_stub()
    with open(resolved, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    kt = np.asarray(dd["kintree_table"])
    id_to_col = {int(kt[1, i]): i for i in range(kt.shape[1])}
    parents = [-1] + [id_to_col[int(kt[0, i])] for i in range(1, kt.shape[1])]
    jr = dd["J_regressor"]
    jr = np.asarray(jr.todense()) if hasattr(jr, "todense") else np.asarray(jr)
    return ManoModel(
        v_template=np.asarray(dd["v_template"], np.float32),
        shapedirs=np.asarray(dd["shapedirs"], np.float32),
        posedirs=np.asarray(dd["posedirs"], np.float32),
        J_regressor=jr.astype(np.float32),
        weights=np.asarray(dd["weights"], np.float32),
        hands_components=np.asarray(dd["hands_components"], np.float32),
        hands_mean=np.asarray(dd["hands_mean"], np.float32),
        parents=tuple(parents),
        faces=np.asarray(dd["f"], np.int32),
    )


def synthetic_mano(seed: int = 0) -> ManoModel:
    """A seeded stand-in with MANO's exact shapes, for machines without
    the licensed asset: the JAX package's draws, in its order."""
    rng = np.random.default_rng(seed)
    V, J = 778, 16
    v_template = rng.normal(scale=0.03, size=(V, 3)).astype(np.float32)
    shapedirs = rng.normal(scale=0.01, size=(V, 3, 10)).astype(np.float32)
    posedirs = rng.normal(scale=0.001, size=(V, 3, 135)).astype(np.float32)
    # each joint regresses from its own random vertex bucket
    J_regressor = np.zeros((J, V), np.float32)
    for j in range(J):
        idx = rng.choice(V, size=10, replace=False)
        J_regressor[j, idx] = 0.1
    weights = rng.uniform(size=(V, J)).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    hands_components = rng.normal(size=(45, 45)).astype(np.float32)
    hands_mean = rng.normal(scale=0.1, size=(45,)).astype(np.float32)
    parents = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
    faces = np.zeros((1538, 3), np.int32)
    return ManoModel(v_template, shapedirs, posedirs, J_regressor, weights,
                     hands_components, hands_mean, parents, faces)


# fingertip mesh vertices inserted at joint slots 4/8/12/16/20
# (reference MANOLayer.py:196-200)
_TIP_VERTS = (333, 444, 672, 555, 745)
_TIP_SLOTS = (4, 8, 12, 16, 20)
_ROOT_ROT = (np.pi, 0.0, 0.0)
_BETAS = 10      # shape coefficients (the reference's bases_num)


class ManoLayer(nn.Module):
    """MANO forward with no trainable parameters:
    ``forward(rots, poses, betas) -> (vertices (B, 778, 3), joints
    (B, 21, 3))``, float32 (reference MANOLayer.py:122-240).

    The constants are non-persistent buffers: ``.to(device)`` moves them,
    and neither ``state_dict()`` nor the flax variables hold them (the
    JAX layer is a plain Python object).
    """

    def __init__(self, model: ManoModel, pose_num: int = 10):
        super().__init__()
        self.pose_num = pose_num
        self.parents = model.parents

        def const(name, value):
            self.register_buffer(name, torch.tensor(
                np.asarray(value), dtype=torch.float32), persistent=False)

        const("v_template", model.v_template)
        # (10, 778 * 3), the reference's permute + reshape
        basis = np.transpose(model.shapedirs, (2, 0, 1))
        const("shape_basis", basis.reshape(basis.shape[0], -1)[:_BETAS])
        const("posedirs", model.posedirs)
        const("J_regressor", model.J_regressor)
        const("weights", model.weights)
        const("hands_components", model.hands_components[:pose_num])
        const("hands_mean", model.hands_mean)
        const("root_rot", np.asarray(_ROOT_ROT, np.float32))

    def forward(self, rots: torch.Tensor, poses: torch.Tensor,
                betas: torch.Tensor):
        """rots (B, 3) global axis-angle; poses (B, pose_num) PCA
        coefficients; betas (B, 10) shape coefficients."""
        B = rots.shape[0]
        K = 16
        V = self.v_template.shape[0]

        # PCA pose -> 15 per-joint axis-angle rotations, the root pinned
        # to [pi, 0, 0] (reference MANOLayer.py:126-128)
        full_pose = (self.hands_mean
                     + poses @ self.hands_components).reshape(B, K - 1, 3)
        pose = torch.cat([self.root_rot.expand(B, 1, 3), full_pose], dim=1)

        # shape blend
        v_shaped = (betas @ self.shape_basis
                    + self.v_template.reshape(-1)).reshape(B, V, 3)

        # pose blend: (R(pose_j) - I) over the 15 non-root joints
        pose_mats = rodrigues(pose[:, 1:, :].reshape(-1, 3)).reshape(
            B, K - 1, 3, 3)
        eye = torch.eye(3, dtype=pose_mats.dtype, device=pose_mats.device)
        pose_feat = (pose_mats - eye).reshape(B, -1)             # (B, 135)
        v_posed = v_shaped + torch.einsum("vck,bk->bvc", self.posedirs,
                                          pose_feat)

        # rest-pose joints regressed from the *shaped* (not the posed)
        # mesh (reference MANOLayer.py:139)
        J = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)

        # kintree accumulation, unrolled over the 16-joint tree
        R = rodrigues(pose.reshape(-1, 3)).reshape(B, K, 3, 3)
        G_R = [R[:, 0]]
        G_t = [J[:, 0]]
        for i in range(1, K):
            p = self.parents[i]
            G_R.append(G_R[p] @ R[:, i])
            G_t.append((G_R[p] @ (J[:, i] - J[:, p])[..., None])[..., 0]
                       + G_t[p])
        G_R = torch.stack(G_R, dim=1)                             # (B,16,3,3)
        G_t = torch.stack(G_t, dim=1)                             # (B,16,3)

        # remove the rest pose: t' = t - G_R @ J (reference
        # MANOLayer.py:169-175)
        t_skin = G_t - (G_R @ J[..., None])[..., 0]

        # LBS: per-vertex blended rotation and translation
        R_v = torch.einsum("vj,bjmn->bvmn", self.weights, G_R)
        t_v = torch.einsum("vj,bjm->bvm", self.weights, t_skin)
        v = (R_v @ v_posed[..., None])[..., 0] + t_v               # (B,778,3)

        # joints: the kintree's translations and the 5 fingertip vertices
        jtr = [G_t[:, j] for j in range(K)]
        for slot, vid in zip(_TIP_SLOTS, _TIP_VERTS):
            jtr.insert(slot, v[:, vid])
        joints = torch.stack(jtr, dim=1)                          # (B,21,3)

        # global orientation applied last (reference MANOLayer.py:188-205)
        Rg = rodrigues(rots)
        vertices = torch.einsum("bmn,bvn->bvm", Rg, v)
        joints = torch.einsum("bmn,bjn->bjm", Rg, joints)
        return vertices, joints
