"""World/camera coordinate alignment; port of
nefes_tpu/geometry/transforms.py.

The dataset-build half (WorldSetup.from_json, centring, the dSLAM / COLMAP
/ Cambridge convention flips, the translation rescale and the three
fix_coord pipelines) runs once per scene on the host in float64 numpy,
as the JAX module computes it. fix_coord_supp, the refinement-time world
rescale of an APR pose, is torch and differentiable.

Conventions: poses are camera-to-world (c2w) unless noted; OpenGL camera
(x right, y up, z backward / -z forward).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass(frozen=True)
class WorldSetup:
    """Per-scene world alignment constants (data/<scene>/world_setup.json)."""

    near: float
    far: float
    pose_scale: float
    pose_scale2: float
    move_all_cam_vec: tuple[float, float, float]

    @classmethod
    def from_json(cls, path: str | Path) -> "WorldSetup":
        with open(path) as f:
            d = json.load(f)
        return cls(
            near=float(d["near"]),
            far=float(d["far"]),
            pose_scale=float(d["pose_scale"]),
            pose_scale2=float(d["pose_scale2"]),
            move_all_cam_vec=tuple(float(x) for x in d["move_all_cam_vec"]),
        )

    def vec(self, device="cuda") -> torch.Tensor:
        """[pose_scale, pose_scale2, mx, my, mz] — the ws_vec refinement
        takes."""
        return torch.tensor([self.pose_scale, self.pose_scale2,
                             *self.move_all_cam_vec], dtype=torch.float32,
                            device=device)


def to_hom(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (N, 4, 4)."""
    last = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 1))
    return np.concatenate([poses, last], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """LLFF-style average pose of (N, 3, 4) c2w poses -> (3, 4): centre =
    mean translation, z = mean forward, x = normalize(y_mean × z),
    y = z × x (reference load_7Scenes.py:130-163)."""
    center = poses[..., 3].mean(0)
    z = poses[..., 2].mean(0)
    z = z / np.linalg.norm(z)
    y_ = poses[..., 1].mean(0)
    x = np.cross(y_, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=1)


def center_poses(poses: np.ndarray, pose_avg: np.ndarray | None = None):
    """Express (N, 3, 4) poses in the average-pose frame (reference
    load_7Scenes.py:164-194). Returns (centred (N, 3, 4), pose_avg (3, 4))."""
    if pose_avg is None:
        pose_avg = average_pose(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    centered = np.linalg.inv(pose_avg_homo) @ to_hom(poses)
    return centered[:, :3], pose_avg


# Mirror matrix flipping y and z: dSLAM "up-left-forward" to OpenGL
# "up-right-backward" (reference load_7Scenes.py:320-336)
_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])


def dslam_to_opengl(poses_centered: np.ndarray) -> np.ndarray:
    """7-Scenes dSLAM c2w (centred) -> OpenGL, as the reference's exact
    product M @ (P @ M) (load_7Scenes.py:336; the bracket placement is
    baked into the shipped pose_avg_stats)."""
    hom = to_hom(poses_centered)
    out = _FLIP_YZ[None] @ (hom @ _FLIP_YZ[None])
    return out[:, :3, :4]


def colmap_to_opengl_c2w(w2c: np.ndarray) -> np.ndarray:
    """COLMAP (OpenCV) w2c (N, 3, 4) -> OpenGL c2w (N, 3, 4): negate rows 1
    and 2, then invert (load_7Scenes_colmap.py:150-159)."""
    hom = to_hom(w2c)
    hom = np.concatenate([hom[:, 0:1], -hom[:, 1:2], -hom[:, 2:3],
                          hom[:, 3:4]], axis=1)
    return np.linalg.inv(hom)[:, :3, :4]


def _rot_x(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                     [0, 0, 0, 1.0]])


def cambridge_to_opengl(poses_centered: np.ndarray) -> np.ndarray:
    """Cambridge c2w (centred) -> OpenGL: 180° x-rotation, rotation
    negated, columns mirrored at the x axis (load_Cambridge.py:285-297)."""
    hom = _rot_x(np.pi)[None] @ to_hom(poses_centered)
    hom[:, :3, :3] = -hom[:, :3, :3]
    hom[:, :3, :3] = hom[:, :3, :3] @ np.diag([-1.0, 1.0, 1.0])
    return hom[:, :3, :4]


def rescale_translations(poses: np.ndarray, ws: WorldSetup) -> np.ndarray:
    """t = (t·scale + move_vec)·scale2 (fix_coord's rescale_coord block,
    load_7Scenes.py:342-353)."""
    out = poses.copy()
    out[:, :3, 3] *= ws.pose_scale
    out[:, :3, 3] += np.asarray(ws.move_all_cam_vec)
    out[:, :3, 3] *= ws.pose_scale2
    return out


def fix_coord_7scenes(poses: np.ndarray, pose_avg: np.ndarray,
                      ws: WorldSetup, rescale: bool = True) -> np.ndarray:
    """7-Scenes dSLAM: centre -> flip -> rescale (load_7Scenes.py:284-360)."""
    centered, _ = center_poses(poses.reshape(-1, 3, 4), pose_avg)
    gl = dslam_to_opengl(centered)
    return rescale_translations(gl, ws) if rescale else gl


def fix_coord_7scenes_colmap(w2c: np.ndarray, pose_avg: np.ndarray,
                             ws: WorldSetup, rescale: bool = True
                             ) -> np.ndarray:
    """7-Scenes COLMAP pGT: OpenCV w2c -> OpenGL c2w -> centre -> rescale
    (load_7Scenes_colmap.py:140-205); the flip comes before the centring
    here, unlike the dSLAM path."""
    c2w = colmap_to_opengl_c2w(w2c.reshape(-1, 3, 4))
    centered, _ = center_poses(c2w, pose_avg)
    return rescale_translations(centered, ws) if rescale else centered


def fix_coord_cambridge(poses: np.ndarray, pose_avg: np.ndarray,
                        ws: WorldSetup, rescale: bool = True) -> np.ndarray:
    """Cambridge: centre -> 180°x + mirror -> rescale
    (load_Cambridge.py:250-315)."""
    centered, _ = center_poses(poses.reshape(-1, 3, 4), pose_avg)
    gl = cambridge_to_opengl(centered)
    return rescale_translations(gl, ws) if rescale else gl


def fix_coord_supp(pose: torch.Tensor, ws_vec: torch.Tensor) -> torch.Tensor:
    """Rescale (..., 3, 4) poses into the field's world frame,
    t = (t·scale + move)·scale2 (reference direct_pose_model.py:210-232);
    differentiable, no mutation. ws_vec as WorldSetup.vec()."""
    t = (pose[..., :3, 3] * ws_vec[0] + ws_vec[2:5]) * ws_vec[1]
    return torch.cat([pose[..., :3, :3], t[..., None]], dim=-1)
