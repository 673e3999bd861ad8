"""Cambridge Landmarks loader; port of nefes_tpu/data/cambridge.py
(reference dataset_loaders/cambridge_scenes.py, load_Cambridge.py).

Directory layout (the reference's setup_cambridge.py, images rescaled to
H = 480):

  <root>/<scene>/{train,test}/{rgb,poses,semantic,dpt}/
  <root>/<scene>/world_setup.json, pose_avg_stats.txt

Poses are 4×4 c2w txts; ShopFacade's train frames 35 and 42 are corrupt
and dropped (cambridge_scenes.py:211-218). Semantic masks are
area-resized to H/tinyscale, eroded 7×7 and binarised at 0.5
(get_semantic_mask, cambridge_scenes.py:120-144).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from nefes_tpu_torch.data.images import erode, read_image, resize_area
from nefes_tpu_torch.data.images import load_images as read_images
from nefes_tpu_torch.data.scene import SceneData, compute_histograms
from nefes_tpu_torch.geometry.transforms import (
    WorldSetup, average_pose, fix_coord_cambridge,
)

DEFAULT_HWF = (480, 854, 744.0)  # cambridge_scenes.py:149


def load_semantic_mask(path: str, h: int, w: int,
                       erosion: bool = True) -> np.ndarray:
    """Binary static-region mask at (h, w) (cambridge_scenes.py:120-144)."""
    mask = (read_image(path) / 255.0).astype(np.float32)
    mask = resize_area(mask, h, w)
    if erosion:
        mask = erode(mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    return (mask > 0.5).astype(np.float32)


def load_dpt_depth(path: str, h: int, w: int) -> np.ndarray:
    """16-bit DPT mono-depth PNG -> (h, w) float, area-resized
    (cambridge_scenes.py:67-73)."""
    d = read_image(path).astype(np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    return resize_area(d, h, w)


def load_cambridge(scene: str, data_root: str,
                   world_setup_dir: str | None = None,
                   train: bool = True, trainskip: int = 1, testskip: int = 1,
                   df: float = 2.0, load_images: bool = True,
                   semantic: bool = False, tinyscale: float = 4.0,
                   hist_bin: int = 10, load_depth: bool = False,
                   load_pose_avg_stats: bool = True,
                   pose_avg_override=None) -> SceneData:
    split_dir = osp.join(data_root, scene, "train" if train else "test")
    rgb_dir = osp.join(split_dir, "rgb")
    pose_dir = osp.join(split_dir, "poses")
    sem_dir = osp.join(split_dir, "semantic")

    ws_dir = world_setup_dir or osp.join(data_root, scene)
    ws = WorldSetup.from_json(osp.join(ws_dir, "world_setup.json"))
    if pose_avg_override is not None:
        pose_avg = np.asarray(pose_avg_override)
    elif load_pose_avg_stats:
        pose_avg = np.loadtxt(osp.join(ws_dir, "pose_avg_stats.txt"))
    else:
        pose_avg = None

    c_imgs = sorted(osp.join(rgb_dir, f) for f in os.listdir(rgb_dir))
    pose_files = sorted(osp.join(pose_dir, f) for f in os.listdir(pose_dir))
    sem_files = (sorted(osp.join(sem_dir, f) for f in os.listdir(sem_dir))
                 if semantic else None)
    if scene == "ShopFacade" and train:  # corrupt frames (ref :211-218)
        for bad in (42, 35):
            del c_imgs[bad]
            del pose_files[bad]
            if sem_files:
                del sem_files[bad]
    if len(c_imgs) != len(pose_files):
        raise ValueError(f"{split_dir}: {len(c_imgs)} images, "
                         f"{len(pose_files)} poses")
    skip = trainskip if train else testskip
    idx = np.arange(len(c_imgs))[::skip] if skip > 1 \
        else np.arange(len(c_imgs))
    c_imgs = [c_imgs[i] for i in idx]
    pose_files = [pose_files[i] for i in idx]
    if sem_files:
        sem_files = [sem_files[i] for i in idx]

    raw = np.stack([np.loadtxt(p)[:3, :4] for p in pose_files])
    if pose_avg is None:
        pose_avg = average_pose(raw)
    poses = fix_coord_cambridge(raw, pose_avg, ws).astype(np.float32)

    H, W, focal = DEFAULT_HWF
    if df != 1.0:
        H, W, focal = int(H // df), int(W // df), focal / df
    images = hists = masks = depths = None
    if load_images:
        images = read_images(c_imgs, df, H, W)
        hists = compute_histograms(images, hist_bin)
        if semantic:
            mh, mw = int(H // tinyscale), int(W // tinyscale)
            masks = np.stack([load_semantic_mask(p, mh, mw)
                              for p in sem_files])
        if load_depth:
            depth_dir = osp.join(split_dir, "dpt")
            if osp.isdir(depth_dir):
                # paired by frame name: a missing map must fail, not shift
                # every later frame onto the wrong depth
                by_name = {osp.splitext(f)[0]: osp.join(depth_dir, f)
                           for f in os.listdir(depth_dir)}
                dfiles = []
                for img_path in c_imgs:
                    stem = osp.splitext(osp.basename(img_path))[0]
                    if stem not in by_name:
                        raise FileNotFoundError(
                            f"dpt depth missing for frame {stem!r} in "
                            f"{depth_dir}")
                    dfiles.append(by_name[stem])
                depths = np.stack([load_dpt_depth(p, H, W) for p in dfiles])
            else:
                print(f"[cambridge] load_depth: no dpt dir at {depth_dir}")
    return SceneData(images=images, poses=poses, hists=hists,
                     hwf=(H, W, focal), near=ws.near, far=ws.far, world=ws,
                     masks=masks, image_paths=c_imgs,
                     raw_poses=raw.astype(np.float32), depths=depths,
                     pose_avg_stats=np.asarray(pose_avg, np.float32))
