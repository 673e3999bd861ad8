"""Mode-2 refinement: APR-weight optimisation, the paper's headline
DFNet + NeFeS50 configuration; port of nefes_tpu/refine/apr_opt.py
(reference script/dm/DFM_APR_refine.py).

Per iteration:
  pose = APR(query image), SVD-orthogonalised (svd_reg)
  -> fix_coord_supp world rescale
  -> render at H/4 -> exposure affine -> FusionNet
  -> bicubic upsample of the fused features and the rgb to full size
  -> 10-px border crop
  -> cosine feature loss -> Adam step on every APR weight
  + PSNR / SSIM of (upsampled rgb, query) for the verification fail-safe.

Each frame starts from a fresh copy of the APR. The loss, PSNR and SSIM
of step i are those of the weights before step i's update; the refined
pose is taken after all updates. The JAX package compiles the loop as one
lax.scan; here it is a Python loop of opt_iter steps.
"""

from __future__ import annotations

import copy

import torch

from nefes_tpu_torch.features.dfnet import DFNet
from nefes_tpu_torch.geometry.se3 import orthogonalize_rotation
from nefes_tpu_torch.geometry.transforms import fix_coord_supp
from nefes_tpu_torch.refine.losses import (
    feature_cosine_loss, masked_feature_cosine_loss,
)
from nefes_tpu_torch.refine.pose_opt import RefineConfig, render_feature_image
from nefes_tpu_torch.render.renderer import RenderConfig
from nefes_tpu_torch.train.losses import psnr as psnr_fn
from nefes_tpu_torch.utils.image import resize_bicubic
from nefes_tpu_torch.utils.ssim import ssim

CROP = 10  # border crop (DFM_APR_refine.py:122-126)


def _crop(img: torch.Tensor) -> torch.Tensor:
    return img[CROP:-CROP, CROP:-CROP]


def apr_pose(dfnet: DFNet, image: torch.Tensor, svd_reg: bool = True,
             freeze_bn: bool = True) -> torch.Tensor:
    """APR forward: (H, W, 3) image -> (3, 4) pose. freeze_bn=False runs
    BN on batch statistics (the reference's un-frozen train() mode)
    without updating the running ones; the pose branch of DFNet has no BN,
    so for DFNet both give the same pose."""
    _, pose12 = dfnet(image[None], return_feature=False, return_pose=True,
                      train_bn=not freeze_bn)
    pose = pose12.reshape(3, 4)
    return orthogonalize_rotation(pose) if svd_reg else pose


def _check_kind(apr_kind: str) -> None:
    if apr_kind != "DFNet":
        raise NotImplementedError(
            f"APR kind {apr_kind!r}: only DFNet is ported; the rest of the "
            "APR zoo is ROADMAP Queue A item 10")


def refine_apr_single(model, dfnet: DFNet, image: torch.Tensor,
                      target_feat: torch.Tensor, hist: torch.Tensor,
                      ws_vec: torch.Tensor, hwf_render: tuple,
                      hwf_full: tuple, near: float, far: float,
                      cfg: RenderConfig, rcfg: RefineConfig,
                      svd_reg: bool = True, mask: torch.Tensor | None = None,
                      freeze_bn: bool = True,
                      apr_kind: str = "DFNet") -> dict:
    """Refine a copy of the APR on ONE query image for rcfg.opt_iter Adam
    steps (learning rate rcfg.learning_rate, optax's defaults otherwise).

    image (H, W, 3); target_feat (H, W, C): full-size DFNet features of
    the query (extracted once outside); mask: optional (H, W) validity
    mask. `dfnet` is left untouched. Returns {refined_pose, initial_pose
    (3, 4), losses (opt_iter,), init_psnr, end_psnr, init_ssim, end_ssim},
    detached."""
    _check_kind(apr_kind)
    H, W, _ = hwf_full
    apr = copy.deepcopy(dfnet).requires_grad_(True)
    params = list(apr.parameters())
    # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8, no eps_root
    opt = torch.optim.Adam(params, lr=rcfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    with torch.no_grad():       # the frozen field: packed once
        packed = model.pack_fused() if cfg.fused else None
    tgt_crop = _crop(target_feat.detach())
    img_crop = _crop(image)
    losses, psnrs, ssims = [], [], []
    for _ in range(rcfg.opt_iter):
        pose = apr_pose(apr, image, svd_reg, freeze_bn)
        rgb_img, fused = render_feature_image(
            model, fix_coord_supp(pose, ws_vec), hist, hwf_render, near, far,
            cfg, fusion_bn=rcfg.fusion, packed=packed)
        fused_up = resize_bicubic(fused[None], H, W)[0]
        rgb_up = resize_bicubic(rgb_img[None], H, W)[0]
        if mask is not None:
            loss = masked_feature_cosine_loss(_crop(fused_up), tgt_crop,
                                              _crop(mask),
                                              per_pixel=rcfg.per_pixel)
        else:
            loss = feature_cosine_loss(_crop(fused_up), tgt_crop,
                                       per_pixel=rcfg.per_pixel)
        # only the APR's gradients: the frozen field, exposure and fusion
        # weights take none, whatever their requires_grad
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            rgb_crop = _crop(rgb_up)
            psnrs.append(psnr_fn(rgb_crop, img_crop))
            ssims.append(ssim(rgb_crop[None], img_crop[None]).mean())
        for p, g in zip(params, grads):
            # None outside the pose branch: Adam skips those weights, as
            # optax leaves a weight with zero gradients where it is
            p.grad = g
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        refined_pose = apr_pose(apr, image, svd_reg, True)
        initial_pose = apr_pose(dfnet, image, svd_reg, True)
    return {"refined_pose": refined_pose, "initial_pose": initial_pose,
            "losses": torch.stack(losses),
            "init_psnr": psnrs[0], "end_psnr": psnrs[-1],
            "init_ssim": ssims[0], "end_ssim": ssims[-1]}


def apply_verification(result: dict, metric: str = "psnr_ssim"
                       ) -> torch.Tensor:
    """The verification fail-safe (DFM_APR_refine.py:242-250): retreat to
    the initial pose if the run degraded under `metric`, for one result or
    a batch of them (leading B).

      "psnr_ssim"  the reference's proxy: retreat when the rendered rgb's
                   PSNR or SSIM fell over the run
      "dfm"        retreat when the feature loss rose (last vs first, both
                   recorded before their step's update)
      "either"     retreat when either signal degrades
    """
    if metric not in ("psnr_ssim", "dfm", "either"):
        raise ValueError(f"verification metric {metric!r}")

    def v(k):
        return torch.as_tensor(result[k])

    retreat = (v("end_psnr") < v("init_psnr")) | (v("end_ssim")
                                                  < v("init_ssim"))
    if metric != "psnr_ssim":
        losses = v("losses")
        dfm = losses[..., -1] > losses[..., 0]
        retreat = dfm if metric == "dfm" else retreat | dfm
    refined, initial = v("refined_pose"), v("initial_pose")
    retreat = retreat.reshape(retreat.shape
                              + (1,) * (refined.ndim - retreat.ndim))
    return torch.where(retreat.to(refined.device), initial, refined)


def refine_apr_verified(model, dfnet: DFNet, images, targets, hists, idx: int,
                        hist_idx: int, ws_vec, hwf_render: tuple,
                        hwf_full: tuple, near: float, far: float,
                        cfg: RenderConfig, rcfg: RefineConfig,
                        svd_reg: bool = True, masks=None,
                        freeze_bn: bool = True, apr_kind: str = "DFNet",
                        use_verification: bool = True,
                        verification_metric: str = "psnr_ssim"
                        ) -> torch.Tensor:
    """The serving step: refine frame `idx` of the staged batch (histogram
    `hist_idx`), apply the verification fail-safe, return the (3, 4)
    pose."""
    out = refine_apr_single(
        model, dfnet, images[idx], targets[idx], hists[hist_idx], ws_vec,
        hwf_render, hwf_full, near, far, cfg, rcfg, svd_reg=svd_reg,
        mask=None if masks is None else masks[idx], freeze_bn=freeze_bn,
        apr_kind=apr_kind)
    return (apply_verification(out, verification_metric)
            if use_verification else out["refined_pose"])


def refine_apr_batch(model, dfnet: DFNet, images, targets, hists, ws_vec,
                     hwf_render: tuple, hwf_full: tuple, near: float,
                     far: float, cfg: RenderConfig, rcfg: RefineConfig,
                     svd_reg: bool = True, masks=None,
                     freeze_bn: bool = True, apr_kind: str = "DFNet") -> dict:
    """Refine B query frames one after another, each from a fresh copy of
    the APR. Returns refine_apr_single's dict with a leading B on every
    entry."""
    outs = [refine_apr_single(
        model, dfnet, images[i], targets[i], hists[i], ws_vec, hwf_render,
        hwf_full, near, far, cfg, rcfg, svd_reg=svd_reg,
        mask=None if masks is None else masks[i], freeze_bn=freeze_bn,
        apr_kind=apr_kind) for i in range(images.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
