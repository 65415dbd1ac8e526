"""Rotation-matrix builders and axis-angle conversion.

Port of ``handpose_tpu/ops/rotations.py`` (reference
utils/canonical_trafo.py:23-91, utils/general.py:59-97 and 191-226,
MANOLayer.py:82-112).  Batch-first, arbitrary leading dimensions.
"""

from __future__ import annotations

import torch

_PI = 3.141592653589793


def atan2_safe(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 in (-pi, pi] via atan + quadrant correction, with the
    reference's 1e-8 guard on x (utils/canonical_trafo.py:23-40)."""
    tan = torch.atan(y / (x + 1e-8))
    tan = torch.where(x + 1e-8 < 0.0, tan + _PI, tan)
    tan = torch.where(tan < 0.0, tan + 2.0 * _PI, tan)
    tan = torch.where(tan > _PI, tan - 2.0 * _PI, tan)
    return tan


def _stitch(rows) -> torch.Tensor:
    """Stack 9 same-shaped tensors (...,) into (..., 3, 3), row-major."""
    m = torch.stack(rows, dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rot_mat_x(angle: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about x."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _stitch([o, z, z, z, c, -s, z, s, c])


def rot_mat_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _stitch([c, z, s, z, o, z, -s, z, c])


def rot_mat_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _stitch([c, -s, z, s, c, z, z, z, o])


def euler_xyz_rot_mat(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler angles -> (..., 3, 3), R = Rx @ Ry @ Rz (reference
    utils/general.py:59-97, the right-hand batch variant)."""
    return (rot_mat_x(angles[..., 0]) @ rot_mat_y(angles[..., 1])
            @ rot_mat_z(angles[..., 2]))


def axis_angle_rot_mat(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle (angle encoded as |u|) -> (..., 3, 3), with the
    reference's ``+1e-8`` inside the norm."""
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    norm = torch.sqrt(ux * ux + uy * uy + uz * uz + 1e-8)
    st, ct = torch.sin(norm), torch.cos(norm)
    one_ct = 1.0 - ct
    nf = 1.0 / norm
    x, y, z = ux * nf, uy * nf, uz * nf
    return _stitch([
        ct + x * x * one_ct, x * y * one_ct - z * st, x * z * one_ct + y * st,
        y * x * one_ct + z * st, ct + y * y * one_ct, y * z * one_ct - x * st,
        z * x * one_ct - y * st, z * y * one_ct + x * st, ct + z * z * one_ct,
    ])


def _skew(v: torch.Tensor) -> torch.Tensor:
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(vx)
    return _stitch([z, -vz, vy, vz, z, -vx, -vy, vx, z])


# rodrigues' small-angle threshold on |r| (reference MANOLayer.py:82)
_SMALL_ANGLE_EPS = 1e-30


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors (angle |r|) -> (..., 3, 3): the closed
    form, or its second-order Taylor expansion where
    ``|r|^2 <= _SMALL_ANGLE_EPS^2`` (reference MANOLayer.py:82-112).

    The threshold is 1e-60, zero in float32, so only an exact zero takes
    the Taylor branch here; XLA on the CPU flushes denormal ``|r|^2`` to
    zero first, so JAX takes it for every |r| below ~1e-19.  The two
    branches agree to float32 rounding there.  The square root's input
    is guarded (1 on the Taylor side): sqrt's infinite derivative at 0
    would otherwise put NaN in the gradient of a zero rotation, MANO's
    natural init, through both sides of the select.
    """
    theta2 = (r * r).sum(dim=-1)
    small = theta2 <= _SMALL_ANGLE_EPS * _SMALL_ANGLE_EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    sn = _skew(r / theta[..., None])
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(sn.shape)
    st = torch.sin(theta)[..., None, None]
    ct = torch.cos(theta)[..., None, None]
    R = eye + st * sn + (1.0 - ct) * (sn @ sn)
    sr = _skew(r)
    t2 = theta2[..., None, None]
    R_small = eye + (1.0 - t2 / 6.0) * sr + (0.5 - t2 / 24.0) * (sr @ sr)
    return torch.where(small[..., None, None], R_small, R)
