"""SO(3)/SE(3) exponential maps and pose composition on torch tensors.

Port of nefes_tpu/geometry/se3.py (the lietorch ``SE3.exp`` replacement of
the reference, script/models/poses.py). Functions act on the trailing axes
and broadcast over leading batch dims. Small-angle cases use series
expansions selected with ``torch.where`` on a safe denominator, so the
gradient at r = 0 (the zero-initialised pose delta the first Adam step
sees) is finite and equal to the series' gradient.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric (hat) matrix."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(θ)/θ, series-expanded near 0."""
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """(1 - cos θ)/θ², series-expanded near 0."""
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 0.5 - theta * theta / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _vterm(theta: torch.Tensor) -> torch.Tensor:
    """(θ - sin θ)/θ³, series-expanded near 0."""
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 / 6.0 - theta * theta / 120.0,
                       (safe - torch.sin(safe)) / safe ** 3)


def _safe_norm(r: torch.Tensor) -> torch.Tensor:
    """||r|| with a finite gradient at r = 0."""
    return torch.sqrt(torch.sum(r * r, dim=-1) + 1e-24)


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta = _safe_norm(r)
    K = skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return (eye + _sinc(theta)[..., None, None] * K
            + _cosc(theta)[..., None, None] * (K @ K))


def so3_left_jacobian(r: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V = I + cosc(θ)·K + vterm(θ)·K² of SO(3)."""
    theta = _safe_norm(r)
    K = skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return (eye + _cosc(theta)[..., None, None] * K
            + _vterm(theta)[..., None, None] * (K @ K))


def pack_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)    # a fill, not a copy from the host
    return torch.cat([top, bottom], dim=-2)


def to_homogeneous(pose34: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) by appending [0, 0, 0, 1]."""
    return pack_se3(pose34[..., :3, :3], pose34[..., :3, 3])


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) ordered [t, r] -> SE(3) matrix (..., 4, 4), with the
    translation V(r) @ t of the exact exp-map."""
    t, r = tau[..., :3], tau[..., 3:6]
    trans = (so3_left_jacobian(r) @ t[..., None])[..., 0]
    return pack_se3(so3_exp(r), trans)


def compose_delta(delta44: torch.Tensor, init44: torch.Tensor) -> torch.Tensor:
    """The reference LearnPose composition: R = R_delta @ R_init,
    t = t_delta + t_init (not a full matrix product)."""
    R = delta44[..., :3, :3] @ init44[..., :3, :3]
    t = delta44[..., :3, 3] + init44[..., :3, 3]
    return pack_se3(R, t)


def learn_pose(r: torch.Tensor, t: torch.Tensor,
               init_c2w: torch.Tensor) -> torch.Tensor:
    """c2w (..., 4, 4) = compose(SE3.exp([t, r]), init); differentiable
    in (r, t)."""
    delta = se3_exp(torch.cat([t, r], dim=-1))
    return compose_delta(delta, to_homogeneous(init_c2w[..., :3, :4]))


def rotation_angle(R: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Geodesic rotation angle of (..., 3, 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    ang = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    return torch.rad2deg(ang) if degrees else ang


class _PolarFactor(torch.autograd.Function):
    """U Vᵀ of R = U Σ Vᵀ, the orthogonal factor of R's polar
    decomposition. Its derivative dQ = U X Vᵀ, X = (Ω - Ωᵀ) / (σi + σj)
    elementwise with Ω = Uᵀ dR V, needs only R non-singular; the SVD's
    own backward divides by σi² - σj², which is 0 on a rotation (the
    quaternion-headed APRs) and gives NaN."""

    @staticmethod
    def forward(ctx, R):
        u, s, vh = torch.linalg.svd(R, full_matrices=False)
        ctx.save_for_backward(u, s, vh)
        return u @ vh

    @staticmethod
    def backward(ctx, g):
        u, s, vh = ctx.saved_tensors
        m = u.transpose(-1, -2) @ g @ vh.transpose(-1, -2)
        k = (m - m.transpose(-1, -2)) / (s[..., :, None] + s[..., None, :])
        return u @ k @ vh


def orthogonalize_rotation(pose: torch.Tensor) -> torch.Tensor:
    """SVD re-orthogonalisation of the rotation block of (..., 3, 4) poses:
    R -> U Vᵀ (the reference's ``svd_reg``). Differentiable wherever R is
    non-singular (_PolarFactor)."""
    return torch.cat([_PolarFactor.apply(pose[..., :3, :3]),
                      pose[..., :3, 3:4]], dim=-1)


# Newton steps of the polar iteration: f64 rounding at condition number
# 4e3 (tests/test_torch_serve.py)
POLAR_ITERS = 12


def orthogonalize_rotation_polar(pose: torch.Tensor) -> torch.Tensor:
    """orthogonalize_rotation in elementwise operations only: U Vᵀ is the
    orthogonal factor of R's polar decomposition, reached by Newton's
    iteration X <- (ζX + (ζX)⁻ᵀ)/2 with ζ = |det X|^(-1/3) (Higham), the
    3×3 inverse as cofactors over the determinant. torch.linalg.svd reads
    its error flag back to the host on a CUDA tensor, which a CUDA graph
    cannot capture; this can be. Differentiable through the iterations;
    R must be non-singular."""
    X = pose[..., :3, :3]
    for _ in range(POLAR_ITERS):
        r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
        cof = torch.stack([torch.linalg.cross(r1, r2),
                           torch.linalg.cross(r2, r0),
                           torch.linalg.cross(r0, r1)], dim=-2)
        det = (r0 * cof[..., 0, :]).sum(-1)[..., None, None]
        zeta = det.abs() ** (-1.0 / 3.0)
        X = 0.5 * (zeta * X + cof / (zeta * det))
    return torch.cat([X, pose[..., :3, 3:4]], dim=-1)


_QUAT_EPS = 1e-8


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4), (w, x, y, z), normalised first -> rotation
    matrix (..., 3, 3) (the reference's qvec2rotmat,
    script/utils/lie_group_helper.py:84-97)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=_QUAT_EPS)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (w, x, y, z),
    w >= 0: of Shepperd's four constructions the one whose pivot
    1 ± m00 ± m11 ± m22 is largest, selected elementwise."""
    m = R
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    ts = torch.stack([1.0 + d0 + d1 + d2, 1.0 + d0 - d1 - d2,
                      1.0 - d0 + d1 - d2, 1.0 - d0 - d1 + d2], -1)
    s = torch.sqrt(torch.clamp(ts, min=_QUAT_EPS)) * 2.0
    s0, s1, s2, s3 = s.unbind(-1)
    a21, a12 = m[..., 2, 1], m[..., 1, 2]
    a02, a20 = m[..., 0, 2], m[..., 2, 0]
    a10, a01 = m[..., 1, 0], m[..., 0, 1]
    qs = torch.stack([
        torch.stack([s0 * 0.25, (a21 - a12) / s0, (a02 - a20) / s0,
                     (a10 - a01) / s0], -1),
        torch.stack([(a21 - a12) / s1, s1 * 0.25, (a01 + a10) / s1,
                     (a02 + a20) / s1], -1),
        torch.stack([(a02 - a20) / s2, (a01 + a10) / s2, s2 * 0.25,
                     (a12 + a21) / s2], -1),
        torch.stack([(a10 - a01) / s3, (a02 + a20) / s3, (a12 + a21) / s3,
                     s3 * 0.25], -1),
    ], dim=-2)                                   # (..., 4 candidates, 4)
    idx = ts.argmax(-1)[..., None, None].expand(*ts.shape[:-1], 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
