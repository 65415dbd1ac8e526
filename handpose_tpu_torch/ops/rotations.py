"""Rotation-matrix builders and axis-angle conversion.

Port of ``handpose_tpu/ops/rotations.py`` (reference
utils/canonical_trafo.py:23-91, utils/general.py:191-226).  Batch-first,
arbitrary leading dimensions.
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
