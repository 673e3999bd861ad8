"""Validation and test-set renders; port of nefes_tpu/render/validation.py
(reference script/models/rendering.py:246-318 render_path, :320-414
render_test, :521-640 render_path_with_feature).

Periodic test-set renders of NeFeS training: PSNR, the feature cosine
loss against DFNet's features of the ground truth, and PNG artefacts
(render, ground truth, disparity, feature-saliency grids), optionally
mp4s. The reference's LARGE_FEATURE_SIZE=True branch is the behaviour:
render at H/tinyscale, run FusionNet once global_step >= EPOCH_TO_FUSION,
bicubic-upsample features and rgb to the full H×W; the cosine loss is on
maps cropped by 10 px at the border, PSNR on the full rgb
(rendering.py:601-630).

The field is frozen here: each call packs it once, under no_grad, and
renders every pose with the field fns that cfg asks for (on the card the
kernels without weight gradients: K5, or K1 under a Nerfies window). A
zoo field (train/field_zoo.py) renders plain, each view with its own
latents, RGB only (no DFNet, no feature maps).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nefes_tpu_torch.features.dfnet import extract_target_features
from nefes_tpu_torch.refine.losses import feature_cosine_loss
from nefes_tpu_torch.render.renderer import RenderConfig, render_image
from nefes_tpu_torch.train.field_zoo import ZooFieldModel
from nefes_tpu_torch.train.model import NeFeSModel
from nefes_tpu_torch.utils.image import resize_bicubic
from nefes_tpu_torch.utils.viz import (
    ensure_dir, save_feature_saliency, save_png,
)

BORDER_CROP = 10   # rendering.py:605-607
EPOCH_TO_FUSION = 200
FULL_BLOCK_RAYS = 4096   # rays a block of a full-resolution render


def _device(model: NeFeSModel) -> torch.device:
    return next(model.parameters()).device


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _render_one(model: NeFeSModel, fns, pose34, hist, hwf: tuple,
                near: float, far: float, cfg: RenderConfig,
                tinyscale: float, use_fusion: bool, window=None) -> dict:
    """Render one pose at H/tinyscale; returns the full-size rgb and feature
    maps (bicubic-upsampled) and the small rgb and disparity maps."""
    H, W, focal = hwf
    h, w = int(H // tinyscale), int(W // tinyscale)
    out = render_image(*fns, h, w, focal / tinyscale, pose34, near, far,
                       cfg, window=window)
    rgb = model.apply_exposure(hist[None], out["rgb"].reshape(1, -1, 3))
    rgb_small = rgb.reshape(h, w, 3)
    if use_fusion:
        feat = model.apply_fusion(rgb_small[None], out["feat"][None])[0]
    else:
        feat = out["feat"]
    return {"rgb_small": rgb_small, "rgb": resize_bicubic(rgb_small, H, W),
            "feat": resize_bicubic(feat.float(), H, W),
            "disp": out["disp"].reshape(h, w)}


def _view_fns(model, fns, hist):
    """One view's field fns: a zoo field's fine field takes the view's
    latents (ray_field_fns, as the JAX package binds them in each view's
    render); NeRFH-NFF's takes none, so `fns`, packed once a call."""
    return model.ray_field_fns(hist) if isinstance(model, ZooFieldModel) \
        else fns


def _crop(x):
    return x[BORDER_CROP:-BORDER_CROP, BORDER_CROP:-BORDER_CROP]


def _save_disp(path: str, disp: np.ndarray) -> None:
    save_png(path, disp / max(disp.max(), 1e-8))


@torch.no_grad()
def render_path_with_feature(model: NeFeSModel, poses, hists, hwf: tuple,
                             near: float, far: float, cfg: RenderConfig,
                             gt_images, dfnet, global_step: int,
                             tinyscale: float = 4.0,
                             savedir: str | None = None,
                             window=None) -> dict:
    """poses (N, 3, 4), hists (N, bins), gt_images (N, H, W, 3) f32 in
    [0, 1]; dfnet the frozen DFNet of the targets.

    Returns {"psnr": mean, "feat_cos": mean, "per_frame": [...],
    "frames_rgb", "frames_disp"} and, when savedir is set, writes
    {i:03d}.png / _GT / _disp / _feature{,_gt}.png per frame (reference
    rendering.py:609-630)."""
    H, W, _ = hwf
    dev = _device(model)
    use_fusion = global_step >= EPOCH_TO_FUSION
    gt_feats = extract_target_features(dfnet, _tensor(gt_images, dev), H, W)
    fns = model.field_fns(cfg)
    psnrs, coses, frames_rgb, frames_disp = [], [], [], []
    if savedir:
        ensure_dir(savedir)
    for i in range(len(poses)):
        hist = _tensor(hists[i], dev)
        out = _render_one(model, _view_fns(model, fns, hist),
                          _tensor(poses[i], dev), hist, hwf, near, far, cfg,
                          tinyscale, use_fusion, window)
        rgb = out["rgb"].float().cpu().numpy()
        gt = np.asarray(gt_images[i])
        # PSNR over the FULL image: the reference crops only the feature
        # maps, not the rgb (rendering.py:601-607)
        p = -10.0 * np.log10(np.mean(np.square(rgb - gt)))
        feat_c = _crop(out["feat"])
        gt_c = _crop(gt_feats[i])
        cos = float(feature_cosine_loss(feat_c, gt_c, per_pixel=True))
        disp = out["disp"].float().cpu().numpy()
        psnrs.append(float(p))
        coses.append(cos)
        frames_rgb.append(np.clip(rgb, 0.0, 1.0))
        frames_disp.append(disp)
        if savedir:
            save_png(os.path.join(savedir, f"{i:03d}.png"), rgb)
            save_png(os.path.join(savedir, f"{i:03d}_GT.png"), gt)
            _save_disp(os.path.join(savedir, f"{i:03d}_disp.png"), disp)
            save_feature_saliency(
                os.path.join(savedir, f"{i:03d}_feature.png"),
                feat_c.cpu().numpy())
            save_feature_saliency(
                os.path.join(savedir, f"{i:03d}_feature_gt.png"),
                gt_c.float().cpu().numpy())
    return {"psnr": float(np.mean(psnrs)),
            "feat_cos": float(np.mean(coses)),
            "per_frame": list(zip(psnrs, coses)),
            "frames_rgb": np.stack(frames_rgb),
            "frames_disp": np.stack(frames_disp)}


def _render_one_full(model: NeFeSModel, fns, pose34, hist, hwf: tuple,
                     near: float, far: float, cfg: RenderConfig,
                     window=None) -> dict:
    """Render one pose at the full H×W in blocks of FULL_BLOCK_RAYS rays:
    the exposure-corrected rgb (H, W, 3) and the disparity (H, W)."""
    H, W, focal = hwf
    out = render_image(*fns, H, W, focal, pose34, near, far, cfg,
                       block_rays=FULL_BLOCK_RAYS, window=window)
    rgb = model.apply_exposure(hist[None], out["rgb"].reshape(1, -1, 3))
    return {"rgb": rgb.reshape(H, W, 3), "disp": out["disp"]}


@torch.no_grad()
def render_path(model: NeFeSModel, poses, hists, hwf: tuple, near: float,
                far: float, cfg: RenderConfig, gt_images=None,
                savedir: str | None = None, window=None) -> dict:
    """Full-resolution render of each pose, PSNR against gt_images when
    given, PNG dumps (reference rendering.py:246-318)."""
    dev = _device(model)
    fns = model.field_fns(cfg)
    psnrs, frames_rgb, frames_disp = [], [], []
    if savedir:
        ensure_dir(savedir)
    for i in range(len(poses)):
        hist = _tensor(hists[i], dev)
        out = _render_one_full(model, _view_fns(model, fns, hist),
                               _tensor(poses[i], dev), hist, hwf, near, far,
                               cfg, window)
        rgb = out["rgb"].float().cpu().numpy()
        disp = out["disp"].float().cpu().numpy()
        frames_rgb.append(np.clip(rgb, 0.0, 1.0))
        frames_disp.append(disp)
        if gt_images is not None:
            gt = np.asarray(gt_images[i])
            psnrs.append(float(-10.0 * np.log10(
                np.mean(np.square(rgb - gt)))))
        if savedir:
            save_png(os.path.join(savedir, f"{i:03d}.png"), rgb)
            if gt_images is not None:
                save_png(os.path.join(savedir, f"{i:03d}_GT.png"),
                         np.asarray(gt_images[i]))
            _save_disp(os.path.join(savedir, f"{i:03d}_disp.png"), disp)
    return {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
            "frames_rgb": np.stack(frames_rgb) if frames_rgb else None,
            "frames_disp": np.stack(frames_disp) if frames_disp else None}


def render_test(model: NeFeSModel, train_views: dict, val_views: dict,
                hwf: tuple, near: float, far: float, cfg: RenderConfig,
                dfnet, global_step: int, basedir: str, expname: str,
                tinyscale: float = 4.0, with_feature: bool = True,
                window=None, render_video: tuple = (False, False)) -> dict:
    """Render holdout train views and the val views into
    evaluate_{train,val}_{step:06d} dirs (reference run_nefes.py:387-481,
    rendering.py:320-414). views: dicts of poses / hists / images arrays.

    render_video: (train, val) flags; each writes <expname>_<split>set_
    <step>_{rgb,disp}.mp4 beside the evaluate dirs (reference
    render_video_train / render_video_test, run_nefes.py:360-364,
    407-411)."""
    results = {}
    for (name, views), video in zip(
            (("train", train_views), ("val", val_views)), render_video):
        if views is None or len(views["poses"]) == 0:
            continue
        savedir = os.path.join(basedir, expname,
                               f"evaluate_{name}_{global_step:06d}")
        if with_feature and dfnet is not None:
            results[name] = render_path_with_feature(
                model, views["poses"], views["hists"], hwf, near, far, cfg,
                views["images"], dfnet, global_step, tinyscale=tinyscale,
                savedir=savedir, window=window)
        else:
            results[name] = render_path(
                model, views["poses"], views["hists"], hwf, near, far, cfg,
                gt_images=views["images"], savedir=savedir, window=window)
        print(f"[render_test] {name}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results[name].items()
            if isinstance(v, float)), flush=True)
        if video and results[name].get("frames_rgb") is not None:
            from nefes_tpu_torch.utils.video import write_mp4
            base = os.path.join(basedir, expname,
                                f"{expname}_{name}set_{global_step:06d}_")
            disps = results[name]["frames_disp"]
            write_mp4(base + "rgb.mp4", results[name]["frames_rgb"])
            write_mp4(base + "disp.mp4", disps / max(disps.max(), 1e-8))
            print(f"[render_test] wrote {base}{{rgb,disp}}.mp4", flush=True)
    return results


@torch.no_grad()
def render_path_upsample(model: NeFeSModel, poses, hists, hwf: tuple,
                         near: float, far: float, cfg: RenderConfig,
                         target_size=(1920, 1080),
                         savedir: str | None = None) -> np.ndarray:
    """Render each pose at hwf and bicubic-upsample the rgb to
    target_size (W, H), the 1080p experiment renderer (reference
    render_path_upsample / render_test_upsample, rendering.py:416-519).
    Returns (N, target_H, target_W, 3); writes frame%05d.png when asked."""
    H, W, _ = hwf
    tw, th = target_size
    dev = _device(model)
    fns = model.field_fns(cfg)
    if savedir:
        ensure_dir(savedir)
    out = []
    for i in range(len(poses)):
        hist = _tensor(hists[i], dev)
        rgb = _render_one_full(model, _view_fns(model, fns, hist),
                               _tensor(poses[i], dev), hist, hwf, near, far,
                               cfg)["rgb"].float()
        if (tw, th) != (W, H):
            rgb = resize_bicubic(rgb, th, tw)
        rgb = torch.clamp(rgb, 0.0, 1.0).cpu().numpy()
        out.append(rgb)
        if savedir:
            save_png(os.path.join(savedir, f"frame{i + 1:05d}.png"), rgb)
    return np.stack(out)


def holdout_views(scene, skip: int = 10, limit: int | None = None) -> dict:
    """Every skip-th view of a SceneData (reference j_skip=10,
    run_nefes.py:399)."""
    idx = np.arange(len(scene))[::skip]
    if limit:
        idx = idx[:limit]
    return {"poses": scene.poses[idx], "hists": scene.hists[idx],
            "images": scene.images[idx]}


@torch.no_grad()
def render_spiral_video(model: NeFeSModel, scene, hwf: tuple, near: float,
                        far: float, cfg: RenderConfig, out_path: str,
                        n_views: int = 120, fps: int = 15,
                        window=None) -> str:
    """Render a spiral camera path around the scene's training poses and
    write it as an mp4 (the reference's --render_pose_only spiral video,
    options.py:19, via generate_render_pose, load_7Scenes.py:196-233),
    centred on a training pose drawn at random. Returns the mp4 path."""
    from nefes_tpu_torch.data.view_selection import generate_render_pose
    from nefes_tpu_torch.utils.video import write_mp4

    # guard near=0 scenes (7-Scenes world_setup): the LLFF focus-depth
    # formula divides by the close bound
    spiral = generate_render_pose(np.asarray(scene.poses),
                                  (max(near, 0.1), far), n_views=n_views)
    dev = _device(model)
    hist = _tensor(np.asarray(scene.hists).mean(axis=0), dev)
    fns = _view_fns(model, model.field_fns(cfg), hist)
    frames = []
    for pose in spiral:
        out = _render_one_full(model, fns, _tensor(pose[:3, :4], dev), hist,
                               hwf, near, far, cfg, window)
        frames.append(np.clip(out["rgb"].float().cpu().numpy(), 0.0, 1.0))
    return write_mp4(out_path, np.stack(frames), fps=fps)
