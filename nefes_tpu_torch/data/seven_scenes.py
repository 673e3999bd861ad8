"""7-Scenes loaders, dSLAM ground truth and the COLMAP pseudo ground
truth; port of nefes_tpu/data/seven_scenes.py (reference
dataset_loaders/seven_scenes.py, seven_scenes_colmap.py). A SceneData of
numpy arrays, poses already in the field's world frame.

Directory layout (reference setup_7scenes.py):
  <deepslam_root>/<scene>/TrainSplit.txt, TestSplit.txt
  <deepslam_root>/<scene>/seq-NN/frame-XXXXXX.{color.png,pose.txt}
  <deepslam_root>/<scene>/<scene>_{train,test}.txt   (COLMAP pGT)
  <data_root>/7Scenes/<scene>/world_setup.json, pose_avg_stats*.txt
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from nefes_tpu_torch.data.images import load_images as read_images
from nefes_tpu_torch.data.images import read_image, resize_nearest
from nefes_tpu_torch.data.scene import SceneData, compute_histograms
from nefes_tpu_torch.geometry.transforms import (
    WorldSetup, average_pose, colmap_to_opengl_c2w, fix_coord_7scenes,
    fix_coord_7scenes_colmap,
)

DEFAULT_HWF = (480, 640, 585.0)  # seven_scenes_colmap.py:142


def _read_split(base_dir: str, train: bool) -> list[int]:
    name = "TrainSplit.txt" if train else "TestSplit.txt"
    with open(osp.join(base_dir, name)) as f:
        return [int(l.split("sequence")[-1]) for l in f
                if not l.startswith("#")]


def _frame_indices(seq_dir: str, skip: int) -> np.ndarray:
    names = [n for n in os.listdir(seq_dir) if "pose" in n]
    idx = np.array(sorted(int(n[6:12]) for n in names))
    return idx[::skip] if skip > 1 else idx


def _pose_avg(data_dir: str, stats_name: str, load_pose_avg_stats: bool,
              pose_avg_override):
    if pose_avg_override is not None:
        return np.asarray(pose_avg_override)
    if load_pose_avg_stats:
        return np.loadtxt(osp.join(data_dir, stats_name))  # fails if absent
    return None


def _load_images(paths: list[str], df: float, H: int, W: int) -> np.ndarray:
    """Colour images -> (N, H, W, 3) float32 in [0, 1], as the JAX loader
    reads them (nefes_tpu/data/seven_scenes.py:42-62): the native C++
    decoder (nefes_tpu_torch/native: libpng/libjpeg on threads, a box
    downsample equal to cv2.INTER_AREA at integer ratios), which resizes
    to (H, W) whatever df is, unless NEFES_NATIVE_LOADER=0 or it is
    unavailable; Pillow + OpenCV otherwise."""
    if os.environ.get("NEFES_NATIVE_LOADER", "1") != "0":
        try:
            from nefes_tpu_torch.native import load_images_native
            return load_images_native(paths, H, W)
        except Exception as e:
            print(f"[data] native loader unavailable ({e}); PIL fallback")
    return read_images(paths, df, H, W)


def quat_poses_to_w2c(qtf: np.ndarray) -> np.ndarray:
    """(N, 7) [qw qx qy qz tx ty tz] -> (N, 3, 4) w2c in float64
    (seven_scenes_colmap.py:55-79, transforms3d's quat2mat)."""
    q = qtf[:, :4] / np.linalg.norm(qtf[:, :4], axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    out = np.zeros((len(qtf), 3, 4))
    out[:, :3, :3] = R
    out[:, :3, 3] = qtf[:, 4:7]
    return out


def load_7scenes_colmap(scene: str, deepslam_root: str, data_root: str,
                        train: bool = True, trainskip: int = 1,
                        testskip: int = 1, df: float = 2.0,
                        load_images: bool = True, hist_bin: int = 10,
                        load_pose_avg_stats: bool = True,
                        pose_avg_override=None) -> SceneData:
    """The COLMAP pGT split (the paper's dataset); df 2 halves 480×640 to
    240×320 as the DFM configs do."""
    base_dir = osp.join(deepslam_root, scene)
    data_dir = osp.join(data_root, "7Scenes", scene)
    ws = WorldSetup.from_json(osp.join(data_dir, "world_setup.json"))
    pose_avg = _pose_avg(data_dir, "pose_avg_stats_colmap.txt",
                         load_pose_avg_stats, pose_avg_override)

    skip = trainskip if train else testskip
    paths: list[str] = []
    keys: list[str] = []
    for seq in _read_split(base_dir, train):
        seq_dir = osp.join(base_dir, f"seq-{seq:02d}")
        for i in _frame_indices(seq_dir, skip):
            paths.append(osp.join(seq_dir, f"frame-{i:06d}.color.png"))
            keys.append(f"seq-{seq:02d}/frame-{i:06d}.color.png")

    table = np.loadtxt(osp.join(
        base_dir, f"{scene}_{'train' if train else 'test'}.txt"), dtype=str)
    lookup = {row[0]: row[1:].astype(np.float64) for row in table}
    qtf = np.stack([lookup[k] for k in keys])
    focal = float(qtf[0, -1])
    w2c = quat_poses_to_w2c(qtf[:, :7])
    if pose_avg is None:
        # centre on THIS split (reference save_pose_avg_stats); callers
        # loading two splits pass the train split's stats as the override
        pose_avg = average_pose(colmap_to_opengl_c2w(w2c.reshape(-1, 3, 4)))
    # no rescale here (rescale_coord=False, load_7Scenes_colmap.py:56):
    # refinement applies the world rescale to APR poses (fix_coord_supp)
    poses = fix_coord_7scenes_colmap(w2c, pose_avg, ws,
                                     rescale=False).astype(np.float32)

    H, W = DEFAULT_HWF[0], DEFAULT_HWF[1]
    if df != 1.0:
        H, W, focal = int(H // df), int(W // df), focal / df
    images = hists = None
    if load_images:
        images = _load_images(paths, df, H, W)
        hists = compute_histograms(images, hist_bin)
    return SceneData(images=images, poses=poses, hists=hists,
                     hwf=(H, W, focal), near=ws.near, far=ws.far, world=ws,
                     image_paths=paths, raw_poses=w2c.astype(np.float32),
                     pose_avg_stats=np.asarray(pose_avg, np.float32))


def load_depth_png(path: str, h: int, w: int, df: float) -> np.ndarray:
    """Kinect depth PNG (uint16 mm, 65535 invalid -> 0) -> metres, resized
    nearest (reference seven_scenes.py:144-150)."""
    d = read_image(path).astype(np.float32)
    d[d >= 65535] = 0.0
    if df != 1.0:
        d = resize_nearest(d, h, w)
    return d / 1000.0


def load_7scenes_dslam(scene: str, deepslam_root: str, data_root: str,
                       train: bool = True, trainskip: int = 1,
                       testskip: int = 1, df: float = 2.0,
                       load_images: bool = True, hist_bin: int = 10,
                       load_depth: bool = False,
                       load_pose_avg_stats: bool = True,
                       pose_avg_override=None) -> SceneData:
    """The dSLAM ground-truth split (4×4 c2w frame-XXXXXX.pose.txt files,
    seven_scenes.py:279-288); load_depth also reads the paired Kinect
    depth maps."""
    base_dir = osp.join(deepslam_root, scene)
    data_dir = osp.join(data_root, "7Scenes", scene)
    ws = WorldSetup.from_json(osp.join(data_dir, "world_setup.json"))
    pose_avg = _pose_avg(data_dir, "pose_avg_stats.txt",
                         load_pose_avg_stats, pose_avg_override)

    skip = trainskip if train else testskip
    paths: list[str] = []
    raw = []
    for seq in _read_split(base_dir, train):
        seq_dir = osp.join(base_dir, f"seq-{seq:02d}")
        for i in _frame_indices(seq_dir, skip):
            paths.append(osp.join(seq_dir, f"frame-{i:06d}.color.png"))
            raw.append(np.loadtxt(
                osp.join(seq_dir, f"frame-{i:06d}.pose.txt")).flatten()[:12])
    raw = np.stack(raw).reshape(-1, 3, 4)
    if pose_avg is None:
        pose_avg = average_pose(raw)
    poses = fix_coord_7scenes(raw, pose_avg, ws).astype(np.float32)

    H, W, focal = DEFAULT_HWF
    if df != 1.0:
        H, W, focal = int(H // df), int(W // df), focal / df
    images = hists = depths = None
    if load_images:
        images = _load_images(paths, df, H, W)
        hists = compute_histograms(images, hist_bin)
        if load_depth:
            depths = np.stack([
                load_depth_png(p.replace(".color.png", ".depth.png"),
                               H, W, df) for p in paths])
    return SceneData(images=images, poses=poses, hists=hists,
                     hwf=(H, W, focal), near=ws.near, far=ws.far, world=ws,
                     image_paths=paths, raw_poses=raw.astype(np.float32),
                     pose_avg_stats=np.asarray(pose_avg, np.float32),
                     depths=depths)
