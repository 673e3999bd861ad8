"""Absolute trajectory error with Sim(3) / SE(3) Umeyama alignment; port
of nefes_tpu/evaluation/ate.py (reference script/utils/align_traj.py,
comp_ate.py and utils/utils.py:559-679), the closed-form Umeyama solve in
float64 numpy."""

from __future__ import annotations

import numpy as np

from nefes_tpu_torch.evaluation.metrics import pose_errors, summarize


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares dst ≈ s·R @ src + t of (N, 3) point sets ->
    (s, R (3, 3), t (3,))."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_ate_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                          traj_c: np.ndarray | None = None,
                          method: str = "sim3") -> np.ndarray:
    """Align trajectory c (default a) to b with the Sim(3) fitted from a
    to b (align_traj.py:7-51). (N, 3|4, 4) c2w -> (N, 4, 4) float32."""
    if traj_c is None:
        traj_c = traj_a
    s, R, t = umeyama_alignment(traj_a[:, :3, 3], traj_b[:, :3, 3],
                                with_scale=(method == "sim3"))
    R_c = R[None] @ traj_c[:, :3, :3]
    t_c = s * (R[None] @ traj_c[:, :3, 3:4]) + t[None, :, None]
    out = np.concatenate([R_c, t_c], axis=2)
    last = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(out), 1, 1))
    return np.concatenate([out, last], axis=1).astype(np.float32)


def compute_ate(c2ws_a: np.ndarray, c2ws_b: np.ndarray,
                align_a2b: str | None = "sim3") -> dict:
    """Error statistics of trajectory a against b after an optional
    Sim(3) alignment (comp_ate.py:7-32), with the RMSEs."""
    a = np.asarray(c2ws_a)[:, :3, :4]
    b = np.asarray(c2ws_b)[:, :3, :4]
    if align_a2b == "sim3":
        a = align_ate_c2b_use_a2b(a, b)[:, :3, :4]
    errors = pose_errors(a, b)
    stats = summarize(errors)
    stats["rmse_t_m"] = float(np.sqrt((errors[:, 0] ** 2).mean()))
    stats["rmse_r_deg"] = float(np.sqrt((errors[:, 1] ** 2).mean()))
    return stats


def compute_ate_error(refined: np.ndarray, gt: np.ndarray) -> dict:
    """compute_ATE_error (utils.py:602-650): align, then the errors."""
    return compute_ate(refined, gt, align_a2b="sim3")


def compute_none_ate_error(pose1: np.ndarray, pose2: np.ndarray) -> dict:
    """The unaligned variant (utils.py:559-600, eval.py:92-133)."""
    return compute_ate(pose1, pose2, align_a2b=None)
