"""Procedural synthetic scene for dataset-free training runs and tests;
port of nefes_tpu/data/synthetic.py. Ground-truth images are rendered
from an analytic soft-blob field through the port's own renderer and
compositor, so a trained field can in principle reach zero loss.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from nefes_tpu_torch.data.scene import SceneData, compute_histograms
from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.geometry.transforms import WorldSetup
from nefes_tpu_torch.render.renderer import RenderConfig, render_image

_BLOBS = np.array([  # (x, y, z, radius, r, g, b)
    [0.0, 0.0, 0.0, 0.45, 0.9, 0.2, 0.1],
    [0.6, 0.3, -0.2, 0.30, 0.1, 0.8, 0.3],
    [-0.5, -0.3, 0.3, 0.35, 0.2, 0.3, 0.9],
], dtype=np.float32)


def blob_field(xyz_emb, dir_emb=None, sigma_only=False,
               output_transient=False, texture_amp: float = 0.0,
               texture_freq: float = 1.0) -> dict:
    """Analytic soft-blob field, a renderer field fn (it reads the raw
    points, the first 3 embedding channels). texture_amp > 0 modulates the
    albedo with a band-limited pattern, finer with texture_freq > 1 (the
    JAX package's docstring says why); the 8-d "feature" is a positional
    signature."""
    xyz = xyz_emb[..., :3]
    blobs = torch.as_tensor(_BLOBS, device=xyz.device)
    d = torch.linalg.norm(xyz[..., None, :] - blobs[:, :3], dim=-1)
    occ = torch.sigmoid((blobs[:, 3] - d) * 40.0)            # (..., K)
    out = {"static_sigma": 200.0 * occ.max(-1).values}
    if sigma_only:
        return out
    w = occ / torch.clamp_min(occ.sum(-1, keepdim=True), 1e-6)
    rgb = (w[..., None] * blobs[:, 4:7]).sum(-2)
    if texture_amp > 0.0:
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        f = texture_freq
        tex = (0.55 * torch.sin(13.0 * f * x + 2.0 * torch.sin(5.0 * f * y))
               * torch.sin(17.0 * f * y + 1.3)
               + 0.45 * torch.sin(23.0 * f * z + 3.0 * torch.sin(7.0 * f * x))
               * torch.sin(29.0 * f * (x + y) + 0.7))
        if f > 1.0:
            tex = (tex + 0.25 * (torch.sin(31.0 * f * x + 1.1)
                                 * torch.sin(37.0 * f * y + 2.3)
                                 + torch.sin(41.0 * f * (y + z) + 0.4)
                                 * torch.sin(43.0 * f * x + 1.9))) / 1.5
        rgb = rgb * (1.0 - texture_amp * 0.5 * (1.0 + tex[..., None]))
    out["static_rgb"] = rgb
    out["static_feat"] = torch.cat(
        [torch.sin(xyz * 3.0), torch.sin(xyz * 9.0 + 0.5),
         occ.max(-1, keepdim=True).values, d.min(-1, keepdim=True).values],
        dim=-1)
    return out


def look_at_pose(eye: np.ndarray, target: np.ndarray = np.zeros(3),
                 up: np.ndarray = np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """OpenGL c2w (3, 4): camera at eye, -z toward target."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


_GT_CFG = RenderConfig(n_samples=96, n_importance=0, perturb=False,
                       output_transient=False, test_time=True, remat=False,
                       xyz_embed=EmbedConfig(num_freqs=1),
                       dir_embed=EmbedConfig(num_freqs=1))


def _render_blobs(field, pose: np.ndarray, H: int, W: int, focal: float,
                  near: float, far: float, device) -> dict:
    with torch.no_grad():
        return render_image(field, None, H, W, focal,
                            torch.as_tensor(pose, device=device), near, far,
                            _GT_CFG)


def make_synthetic_scene(n_views: int = 12, H: int = 24, W: int = 32,
                         focal: float = 30.0, radius: float = 2.5,
                         near: float = 0.5, far: float = 5.0, seed: int = 0,
                         texture_amp: float = 0.0, texture_freq: float = 1.0,
                         device="cuda") -> SceneData:
    """Cameras on a jittered circle (numpy seed), ground-truth images
    rendered from blob_field on `device`."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = np.array([radius * np.sin(ang),
                        0.4 + 0.2 * rng.standard_normal(),
                        radius * np.cos(ang)], dtype=np.float32)
        poses.append(look_at_pose(eye))
    poses = np.stack(poses)
    field = (partial(blob_field, texture_amp=texture_amp,
                     texture_freq=texture_freq)
             if texture_amp > 0.0 else blob_field)
    imgs = [_render_blobs(field, p, H, W, focal, near, far,
                          device)["rgb"].cpu().numpy() for p in poses]
    images = np.clip(np.stack(imgs), 0.0, 1.0)
    ws = WorldSetup(near=near, far=far, pose_scale=1.0, pose_scale2=1.0,
                    move_all_cam_vec=(0.0, 0.0, 0.0))
    return SceneData(images=images, poses=poses,
                     hists=compute_histograms(images), hwf=(H, W, focal),
                     near=near, far=far, world=ws)


def render_gt_features(scene: SceneData, feature_dim: int = 8,
                       device="cuda") -> np.ndarray:
    """Per-view ground-truth "features" rendered from the analytic field
    (a stand-in for the frozen feature extractor), (N, H, W, feature_dim)."""
    return np.stack([
        _render_blobs(blob_field, p, scene.H, scene.W, scene.focal,
                      scene.near, scene.far,
                      device)["feat"].cpu().numpy()[..., :feature_dim]
        for p in scene.poses])
