"""Multi-frame (consecutive-view) sampling for VLocNet/MapNet-style APR
training; port of nefes_tpu/data/multiframe.py (numpy over the port's
SceneData, as there).

Reference: dataset_loaders/seven_scenes.py:367-432 (SevenScenesMF /
SevenScenesDGR) regroups a scene into shifted index queues so item i
yields [prev, cur] images and [prev-1, prev, cur] poses (clamped at the
start). Here it's a pure index transform over SceneData — no copies of
the image stacks — plus the relative-pose helper MapNet's VO loss uses.
"""

from __future__ import annotations

import numpy as np


def multiframe_indices(n: int, steps: int = 2) -> np.ndarray:
    """(n, steps) index matrix: row i = [i-steps+1, ..., i-1, i] clamped
    at 0 (the reference's shifted-queue construction)."""
    base = np.arange(n)[:, None]
    offs = np.arange(-(steps - 1), 1)[None, :]
    return np.clip(base + offs, 0, n - 1)


def multiframe_batch(scene, index: np.ndarray | int, steps: int = 2,
                     pose_steps: int | None = None) -> dict:
    """Gather a multi-frame item/batch from a SceneData.

    Returns {"images": (..., steps, H, W, 3), "poses": (..., P, 3, 4)}
    with P = pose_steps (default steps+1, the reference's prev-1/prev/cur
    triple for a 2-image pair)."""
    pose_steps = pose_steps or steps + 1
    n = len(scene)
    idx_img = multiframe_indices(n, steps)[index]
    idx_pose = multiframe_indices(n, pose_steps)[index]
    return {"images": scene.images[idx_img],
            "poses": scene.poses[idx_pose],
            "hists": scene.hists[idx_img] if scene.hists is not None
            else None}


def relative_pose(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """T_a^-1 @ T_b for (..., 3, 4) c2w pairs -> (..., 3, 4): the
    frame-to-frame motion MapNet's VO terms consume."""
    Ra, ta = pose_a[..., :3, :3], pose_a[..., :3, 3]
    Rb, tb = pose_b[..., :3, :3], pose_b[..., :3, 3]
    R = np.swapaxes(Ra, -1, -2) @ Rb
    t = np.einsum("...ji,...j->...i", Ra, tb - ta)
    return np.concatenate([R, t[..., None]], axis=-1)
