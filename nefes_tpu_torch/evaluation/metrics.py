"""Pose-error metrics, the acceptance layer; port of
nefes_tpu/evaluation/metrics.py (reference script/eval.py:34-90).

  translation error  ||t_pred - t_gt||  (metres)
  rotation error     the geodesic angle of R_pred @ R_gtᵀ (degrees)

and the accuracy buckets of eval.py. Host-side float64 numpy: these run
once per evaluation over a few thousand poses.
"""

from __future__ import annotations

import numpy as np

# (name, t_threshold_m, r_threshold_deg), in eval.py's print order
ACCURACY_BUCKETS = (
    ("500cm/10deg", 5.0, 10.0),
    ("50cm/5deg", 0.5, 5.0),
    ("25cm/2deg", 0.25, 2.0),
    ("10cm/5deg", 0.1, 5.0),
    ("5cm/5deg", 0.05, 5.0),
    ("2cm/2deg", 0.02, 2.0),
    ("1cm/1deg", 0.01, 1.0),
)


def rotation_angle_np(R: np.ndarray, degrees: bool = True) -> np.ndarray:
    """Geodesic angle of (..., 3, 3) near-rotations. APRs regress the nine
    entries directly, so the matrix is first projected onto SO(3) by SVD,
    as cv2.Rodrigues does in the reference's eval.py:49-50."""
    u, _, vt = np.linalg.svd(R)
    Rp = u @ vt
    tr = np.trace(Rp, axis1=-2, axis2=-1)
    ang = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    return np.degrees(ang) if degrees else ang


def pose_errors(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-frame errors of (N, 3, 4), (N, 4, 4) or (N, 12) poses ->
    (N, 2): [translation error (m), rotation error (deg)]."""
    pred = np.asarray(pred, dtype=np.float64)
    pred = pred.reshape(len(pred), -1)[:, :12].reshape(-1, 3, 4)
    gt = np.asarray(gt, dtype=np.float64)
    gt = gt.reshape(len(gt), -1)[:, :12].reshape(-1, 3, 4)
    t_err = np.linalg.norm(pred[:, :3, 3] - gt[:, :3, 3], axis=-1)
    r_rel = pred[:, :3, :3] @ np.transpose(gt[:, :3, :3], (0, 2, 1))
    return np.stack([t_err, rotation_angle_np(r_rel)], axis=-1)


def accuracy_stats(errors: np.ndarray) -> dict[str, float]:
    """Percent of frames within each (t, r) threshold pair."""
    errors = np.asarray(errors)
    out = {}
    for name, t_th, r_th in ACCURACY_BUCKETS:
        ok = (errors[:, 0] < t_th) & (errors[:, 1] < r_th)
        out[name] = float(ok.mean() * 100.0)
    return out


def summarize(errors: np.ndarray) -> dict:
    """Median and mean errors and the accuracy buckets (eval.py:121-132,
    DFM_APR_refine.py:261-266)."""
    errors = np.asarray(errors)
    med = np.median(errors, axis=0)
    mean = np.mean(errors, axis=0)
    return {
        "median_t_m": float(med[0]),
        "median_r_deg": float(med[1]),
        "mean_t_m": float(mean[0]),
        "mean_r_deg": float(mean[1]),
        "accuracy": accuracy_stats(errors),
        "n_frames": int(len(errors)),
    }


def load_pose_txt(path) -> np.ndarray:
    """An (N, 12) pose txt, one row-major 3×4 pose a line (the reference's
    paper_result format) -> (N, 3, 4) float32."""
    arr = np.loadtxt(path)
    return arr.reshape(arr.shape[0], 3, 4).astype(np.float32)


def save_pose_txt(path, poses: np.ndarray) -> None:
    """(N, 3, 4) poses in the reference's txt format (np.savetxt's %.18e,
    DFM_APR_refine.py:270-276)."""
    np.savetxt(path, np.asarray(poses).reshape(-1, 12))
