"""Visualisation artefacts: PNG writers, feature-saliency grids, camera
frustums; port of nefes_tpu/utils/viz.py (numpy + Pillow).

The reference's imageio/torchvision/matplotlib/open3d stack
(script/utils/utils.py:74-156 save_image_saliancy/plot_features,
script/utils/vis_cam_traj.py:11-99) becomes: saliency grids through an
in-house jet colormap, frustum trajectories as PLY line sets readable by
MeshLab/CloudCompare.
"""

from __future__ import annotations

import os

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, reference's to8b."""
    return (255 * np.clip(np.asarray(x, np.float32), 0.0, 1.0)).astype(
        np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) or (H, W); float [0,1] or uint8."""
    from PIL import Image
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to8b(img)
    Image.fromarray(img).save(path)


def jet(x: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) uint8 jet colormap (the cmap the
    reference passes to plt.imshow for saliency dumps)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def feature_saliency_grid(feat: np.ndarray, nrow: int = 6,
                          pad: int = 2) -> np.ndarray:
    """(H, W, C) feature map -> jet-colored channel grid (uint8 RGB).

    Mirrors save_image_saliancy (utils.py:74-88): channels tiled nrow per
    row, jointly min-max normalized (torchvision make_grid normalize=True
    semantics), rendered through the jet map.
    """
    feat = np.asarray(feat, np.float32)
    h, w, c = feat.shape
    lo, hi = feat.min(), feat.max()
    norm = (feat - lo) / (hi - lo + 1e-12)
    ncol = nrow
    nrows = (c + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad),
                    np.float32)
    for i in range(c):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = norm[..., i]
    return jet(grid)


def save_feature_saliency(path: str, feat: np.ndarray, nrow: int = 6) -> None:
    save_png(path, feature_saliency_grid(feat, nrow=nrow))


def frustum_lines(c2w: np.ndarray, scale: float = 0.1,
                  focal_ratio: float = 1.2) -> tuple[np.ndarray, np.ndarray]:
    """One camera frustum as (5 vertices, 8 edge index pairs) in world
    coords (OpenGL convention, -z forward — reference
    vis_cam_traj.py:11-60)."""
    hw = scale
    hh = scale * 0.75
    d = -scale * focal_ratio
    corners = np.array([
        [0.0, 0.0, 0.0],
        [-hw, -hh, d], [hw, -hh, d], [hw, hh, d], [-hw, hh, d],
    ], np.float32)
    R, t = c2w[:3, :3], c2w[:3, 3]
    verts = corners @ R.T + t
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]], np.int32)
    return verts, edges


def save_camera_frustums_ply(path: str, poses: np.ndarray,
                             scale: float = 0.1) -> None:
    """Write all (N, 3, 4) camera frustums as one PLY line set."""
    all_v, all_e = [], []
    off = 0
    for p in np.asarray(poses):
        v, e = frustum_lines(p, scale)
        all_v.append(v)
        all_e.append(e + off)
        off += len(v)
    verts = np.concatenate(all_v)
    edges = np.concatenate(all_e)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
