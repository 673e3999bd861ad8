"""LLFF / Blender dataset loaders (legacy PoseNet-experiment path); port
of nefes_tpu/data/llff_blender.py (numpy, with the port's resize).

Reference: script/dm/prepare_data.py (load_dataset / load_Colmap_dataset /
prepare_data) and the classic NeRF loaders it calls. Output follows this
framework's conventions: numpy arrays + SceneData-style dicts instead of
torch TensorDataset/DataLoader triples.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from nefes_tpu_torch.data.scene import compute_histograms
from nefes_tpu_torch.utils.image import resize_bilinear


def _resize(imgs: np.ndarray, H: int, W: int) -> np.ndarray:
    """(N, h, w, C) float32 -> (N, H, W, C): the port's bilinear resize
    (half-pixel centres) on the CPU."""
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(imgs)),
                           H, W).numpy()


# ----------------------------------------------------------------------
# blender (NeRF-synthetic transforms_*.json)
# ----------------------------------------------------------------------

def load_blender_data(basedir: str, half_res: bool = False,
                      testskip: int = 1, white_bkgd: bool = False):
    """Returns (images (N,H,W,3), poses (N,4,4), hwf, i_split) — classic
    load_blender_data semantics (near/far are the fixed 2/6)."""
    from PIL import Image

    splits = ("train", "val", "test")
    metas = {s: json.load(open(osp.join(basedir, f"transforms_{s}.json")))
             for s in splits}
    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = osp.join(basedir, frame["file_path"] + ".png")
            img = np.array(Image.open(fname), np.float32) / 255.0
            imgs.append(img)
            poses.append(np.array(frame["transform_matrix"], np.float32))
        all_imgs.append(np.stack(imgs))
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(imgs))
    imgs = np.concatenate(all_imgs)
    poses = np.concatenate(all_poses)
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    H, W = imgs.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * metas["train"]["camera_angle_x"])
    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = _resize(imgs, H, W)

    if imgs.shape[-1] == 4:
        if white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]
    return imgs, poses, (H, W, float(focal)), i_split


# ----------------------------------------------------------------------
# LLFF (poses_bounds.npy)
# ----------------------------------------------------------------------

# pose averaging / recentering live in the canonical transform module
from nefes_tpu_torch.geometry.transforms import center_poses  # noqa: E402


def load_llff_data(basedir: str, factor: float | None = None,
                   recenter: bool = True, bd_factor: float | None = 0.75,
                   spherify: bool = False):
    """poses_bounds.npy + images dir -> (images, poses (N,3,5 with hwf
    column), bds, i_test). Standard LLFF conventions: stored poses are
    [down right back] and get rolled to [right up back]; translations and
    bounds rescaled by 1/(min_bound*bd_factor)."""
    if spherify:
        raise NotImplementedError(
            "spherify=True (360 capture) is not used by any NeFeS "
            "experiment; file an issue if you need it")
    from PIL import Image

    arr = np.load(osp.join(basedir, "poses_bounds.npy"))  # (N, 17)
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]

    img_dir = osp.join(basedir, "images")
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith(("jpg", "jpeg", "png")))
    imgs = []
    for f in files:
        img = np.array(Image.open(osp.join(img_dir, f)), np.float32) / 255.0
        imgs.append(img[..., :3])
    imgs = np.stack(imgs)
    assert len(imgs) == len(poses), (len(imgs), len(poses))

    if factor and factor != 1:
        H, W = imgs.shape[1:3]
        h, w = int(H // factor), int(W // factor)
        imgs = _resize(imgs, h, w)
        poses[:, :2, 4] = [h, w]
        poses[:, 2, 4] = poses[:, 2, 4] / factor

    # [down right back] -> [right up back] (the classic column roll)
    poses = np.concatenate([poses[:, :, 1:2], -poses[:, :, 0:1],
                            poses[:, :, 2:]], 2)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        hwf_col = poses[:, :3, 4:5]
        centered, _ = center_poses(poses[:, :3, :4])
        poses = np.concatenate([centered, hwf_col], 2)

    i_test = int(np.argmin(np.linalg.norm(
        poses[:, :3, 3] - poses[:, :3, 3].mean(0), axis=-1)))
    return imgs, poses.astype(np.float32), bds, i_test


# ----------------------------------------------------------------------
# the prepare_data-style entry (dm/prepare_data.py:100-159)
# ----------------------------------------------------------------------

def load_dataset(dataset_type: str, datadir: str, factor: float = 4,
                 llffhold: int = 8, testskip: int = 1,
                 no_ndc: bool = False, white_bkgd: bool = False,
                 encode_hist: bool = True, hist_bin: int = 10,
                 half_res: bool = True) -> dict:
    """Returns {images, poses12 (N, 12), hwf, i_split, near, far, hists}
    — the load_dataset contract as plain arrays."""
    if dataset_type == "llff":
        imgs, poses, bds, i_test = load_llff_data(datadir, factor=factor)
        hwf = tuple(poses[0, :3, 4])
        poses34 = poses[:, :3, :4]
        if llffhold > 0:
            i_test = np.arange(len(imgs))[::llffhold]
        else:
            i_test = np.array([i_test])
        i_val = i_test
        i_train = np.array([i for i in range(len(imgs))
                            if i not in set(i_test)])
        near, far = ((bds.min() * 0.9, bds.max() * 1.0) if no_ndc
                     else (0.0, 1.0))
        i_split = [i_train, i_val, i_test]
    elif dataset_type == "blender":
        imgs, poses4, hwf, i_split = load_blender_data(
            datadir, half_res=half_res, testskip=testskip,
            white_bkgd=white_bkgd)
        poses34 = poses4[:, :3, :4]
        near, far = 2.0, 6.0
    else:
        raise ValueError(f"unknown dataset_type {dataset_type!r}")

    hists = (compute_histograms(imgs, hist_bin) if encode_hist
             else np.zeros((len(imgs), hist_bin), np.float32))
    return {"images": imgs,
            "poses12": poses34.reshape(len(imgs), 12),
            "hwf": (int(hwf[0]), int(hwf[1]), float(hwf[2])),
            "i_split": i_split, "near": float(near), "far": float(far),
            "hists": hists}
