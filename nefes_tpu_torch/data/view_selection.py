"""Frustum-overlap view selection and spiral render paths; port of
nefes_tpu/data/view_selection.py (numpy).

Reference: dataset_loaders/load_7Scenes.py:42-112 (frustum sampling and
overlap), :361-435 (unique-view and nearest-neighbour selection for local
NeRF data), :123-233 (spiral render poses). One einsum transforms all
frustum points against all candidate poses at once, where the reference
runs `np.apply_along_axis` per point; the greedy keyframe scan stays a
host loop over vectorised overlap rows.
"""

from __future__ import annotations

import numpy as np

SAMPLE_STEP = 0.1


def init_k(f: float, cx: float, cy: float) -> np.ndarray:
    K = np.eye(3)
    K[0, 0] = K[1, 1] = f
    K[0, 2], K[1, 2] = cx, cy
    return K


def default_frustum_params(near_far=(0.0, 2.5)):
    """7-Scenes half-res intrinsics (load_7Scenes.py:44-60)."""
    x_res, y_res, f = 640.0 / 2, 480.0 / 2, 585.0 / 2
    K = init_k(f, x_res / 2, y_res / 2)
    frustum = generate_sampling_frustum(SAMPLE_STEP, near_far[1], K,
                                        x_res, y_res)
    return K, frustum, x_res, y_res


def generate_sampling_frustum(step: float, depth: float, K: np.ndarray,
                              x_res: float, y_res: float) -> np.ndarray:
    """Regular 3-D grid of points inside the camera frustum
    (load_7Scenes.py:73-96) — vectorized over the whole grid."""
    f, cx, cy = K[0, 0], K[0, 2], K[1, 2]
    x_max, x_min = depth * (x_res - cx) / f, -depth * cx / f
    y_max, y_min = depth * (y_res - cy) / f, -depth * cy / f
    zs = np.arange(0, depth, step)
    xs = np.arange(x_min, x_max, step)
    ys = np.arange(y_min, y_max, step)
    Z, X, Y = np.meshgrid(zs, xs, ys, indexing="ij")
    P = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    p = P @ K.T
    keep = p[:, 2] >= 1e-5
    pn = p[keep] / p[keep, 2:3]
    inside = ((0 < pn[:, 0]) & (pn[:, 0] < x_res)
              & (0 < pn[:, 1]) & (pn[:, 1] < y_res))
    return P[keep][inside]


def frustum_overlap(pose0: np.ndarray, poses1: np.ndarray,
                    frustum: np.ndarray, K: np.ndarray,
                    x_res: float, y_res: float) -> np.ndarray:
    """Fraction of pose0's frustum points visible from each pose in
    poses1 (compute_frustums_overlap, load_7Scenes.py:99-112, batched).

    pose0: (3, 4); poses1: (M, 3, 4) or (3, 4). Returns (M,) or scalar.
    """
    single = poses1.ndim == 2
    p1 = poses1[None] if single else poses1
    R0, t0 = pose0[:3, :3], pose0[:3, 3]
    R1, t1 = p1[:, :3, :3], p1[:, :3, 3]
    R10 = np.einsum("mji,jk->mik", R1, R0)             # R1^T @ R0
    t10 = np.einsum("mji,mj->mi", R1, t0[None] - t1)   # R1^T (t0 - t1)
    P = np.einsum("mik,pk->mpi", R10, frustum) + t10[:, None]
    p = np.einsum("ij,mpj->mpi", K, P)
    pn = p / p[..., 2:3]
    inside = ((0 < pn[..., 0]) & (pn[..., 0] < x_res)
              & (0 < pn[..., 1]) & (pn[..., 1] < y_res))
    frac = inside.mean(axis=1)
    return frac[0] if single else frac


def fetch_unique_view_index(poses: np.ndarray, threshold: float,
                            near_far=(0.0, 2.5), save_path=None,
                            verbose: bool = False) -> np.ndarray:
    """Greedy keyframe selection (load_7Scenes.py:361-405): a view is
    'unique' when its frustum overlap with the previous keyframe AND all
    existing unique views is below threshold."""
    K, frustum, xr, yr = default_frustum_params(near_far)
    unique = [0]
    keyframe = 0
    for i in range(len(poses)):
        if i == keyframe:
            continue
        if frustum_overlap(poses[keyframe], poses[i], frustum, K, xr,
                           yr) > threshold:
            continue
        # reference direction: overlap of unique view j's frustum seen
        # from candidate i (the unique set stays small, so this short
        # loop over vectorized rows is fine)
        overlaps = np.array([frustum_overlap(poses[j], poses[i], frustum,
                                             K, xr, yr) for j in unique])
        if np.any(overlaps > threshold):
            keyframe = i
            continue
        unique.append(i)
        if verbose:
            print(f"unique views: {unique}")
        keyframe = i
    out = np.array(unique)
    if save_path:
        np.savetxt(save_path, out, fmt="%d")
    return out


def select_nearest_neighbor_views(poses: np.ndarray, threshold: float,
                                  unique_index: np.ndarray,
                                  near_far=(0.0, 2.5),
                                  stride: int = 5) -> np.ndarray:
    """Indices of views overlapping any unique view above threshold,
    subsampled by `stride` (load_7Scenes.py:407-435). Vectorized: one
    (U, N) overlap matrix instead of the double python loop."""
    K, frustum, xr, yr = default_frustum_params(near_far)
    hits = np.zeros(len(poses), bool)
    for j in unique_index:
        ov = frustum_overlap(poses[j], poses, frustum, K, xr, yr)
        hits |= ov > threshold
    hits[np.asarray(unique_index)] = False   # "i == keyframe" skips
    idx = np.nonzero(hits)[0]
    return idx[::stride]


# ----------------------------------------------------------------------
# spiral render paths (load_7Scenes.py:123-233)
# ----------------------------------------------------------------------

def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2,
                       n_views=120) -> np.ndarray:
    """(N, 3, 4) spiral of poses around c2w (load_7Scenes.py:196-205)."""
    rads = np.array(list(rads) + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return np.stack(out)


def generate_render_pose(poses: np.ndarray, bds, n_views: int = 120,
                         rng: np.random.Generator | None = None
                         ) -> np.ndarray:
    """Spiral around a random training pose with LLFF-style focus depth
    (load_7Scenes.py:207-233)."""
    rng = rng or np.random.default_rng()
    c2w = poses[rng.integers(len(poses))]
    up = _normalize(poses[:, :3, 1].sum(0))
    close, inf = np.min(bds) * 0.9, np.max(bds) * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close + dt / inf)
    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 20, axis=0)
    return render_path_spiral(c2w, up, rads, focal, rots=2,
                              n_views=n_views)
