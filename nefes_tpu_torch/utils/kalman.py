"""Kalman trajectory smoothing — Kalman1D / Kalman3D parity; port of
nefes_tpu/utils/kalman.py (numpy, float64, as there).

Reference: script/utils/utils.py:252-312 smooths pose time series with
pykalman (scalar constant-position model: transition 1, transition cov
0.1, observation cov = damping, initial mean = first observation).
Implemented directly as a forward Kalman filter + RTS backward smoother
in numpy — no pykalman dependency.
"""

from __future__ import annotations

import numpy as np


def kalman_1d(observations: np.ndarray, damping: float = 1.0) -> np.ndarray:
    """Smooth a scalar series (N,) -> (N, 1) like reference Kalman1D."""
    z = np.asarray(observations, np.float64).reshape(-1)
    n = len(z)
    q, r = 0.1, float(damping)        # transition / observation covariance

    means = np.empty(n)
    covs = np.empty(n)
    pred_means = np.empty(n)
    pred_covs = np.empty(n)

    # forward filter (pykalman convention: the initial state is UPDATED
    # with the first observation too)
    m, p = z[0], float(damping)       # initial mean/cov
    for t in range(n):
        if t > 0:
            m, p = m, p + q           # predict (transition = identity)
        pred_means[t], pred_covs[t] = m, p
        k = p / (p + r)               # update
        m = m + k * (z[t] - m)
        p = (1.0 - k) * p
        means[t], covs[t] = m, p

    # RTS backward smoother
    sm = np.empty(n)
    sp = np.empty(n)
    sm[-1], sp[-1] = means[-1], covs[-1]
    for t in range(n - 2, -1, -1):
        c = covs[t] / pred_covs[t + 1]
        sm[t] = means[t] + c * (sm[t + 1] - pred_means[t + 1])
        sp[t] = covs[t] + c * (sp[t + 1] - pred_covs[t + 1]) * c
    return sm.reshape(-1, 1)


def kalman_3d(observations: np.ndarray, damping: float = 1.0) -> np.ndarray:
    """Smooth (N, 3) positions axis-by-axis (reference Kalman3D)."""
    obs = np.asarray(observations, np.float64)
    return np.concatenate([kalman_1d(obs[:, i], damping)
                           for i in range(3)], axis=1)
