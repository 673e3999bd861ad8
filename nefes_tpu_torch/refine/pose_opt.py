"""Mode-3 refinement: explicit SE(3) pose-delta optimisation; port of
nefes_tpu/refine/pose_opt.py (reference script/dm/DFM_pose_refine.py:
290-453).

Per iteration: pose = SE3.exp([t, r]) ∘ init -> fix_coord_supp world
rescale -> render at H/tinyscale -> exposure affine -> FusionNet (batch
statistics by default) -> cosine feature loss against the target -> Adam
step with lr_r on r and lr_t on t. The JAX package compiles the loop as
one lax.scan; here it is a Python loop of opt_iter steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nefes_tpu_torch.geometry.se3 import learn_pose
from nefes_tpu_torch.geometry.transforms import WorldSetup, fix_coord_supp
from nefes_tpu_torch.refine.losses import (
    feature_cosine_loss, masked_feature_cosine_loss,
)
from nefes_tpu_torch.render.renderer import RenderConfig, render_image


@dataclass(frozen=True)
class RefineConfig:
    opt_iter: int = 50
    lr_r: float = 0.01
    lr_t: float = 0.1
    per_pixel: bool = False
    learning_rate: float = 1e-5   # mode-2 APR learning rate
    fusion: str = "batch"         # "batch" | "running" | "none"


def render_feature_image(model, pose34: torch.Tensor, hist: torch.Tensor,
                         hwf: tuple, near: float, far: float,
                         cfg: RenderConfig, block_rays: int = 0,
                         fusion_bn: str = "batch", packed=None):
    """Render at (h, w) and run exposure + fusion, the shared forward of
    both refinement modes. Returns (rgb_img (h, w, 3), fused (h, w, F)).

    With cfg.fused the field runs through the kernels, the pre-embedded
    ones (cfg.fused_pre) or the raw-input ones: `packed` is
    model.pack_fused() (packed here when None)."""
    h, w, focal = hwf
    coarse, fine = (model.field_fns(cfg, packed) if cfg.fused
                    else (model.coarse_fn, model.fine_fn))
    out = render_image(coarse, fine, h, w, focal, pose34, near, far, cfg,
                       block_rays=block_rays)
    rgb = model.apply_exposure(hist[None], out["rgb"].reshape(1, -1, 3))
    rgb_img = rgb.reshape(h, w, 3)
    if fusion_bn == "none":
        return rgb_img, out["feat"]
    fused = model.apply_fusion(rgb_img[None], out["feat"][None],
                               bn_stats=fusion_bn)
    return rgb_img, fused[0]


def _pose_from(r, t, init_pose, ws_vec):
    """(c2w (3, 4) in the dataset frame, the same pose rescaled into the
    field's frame)."""
    c2w = learn_pose(r, t, init_pose)[..., :3, :4]
    return c2w, fix_coord_supp(c2w, ws_vec)


def refine_pose_single(model, init_pose: torch.Tensor,
                       target_feat: torch.Tensor, hist: torch.Tensor,
                       ws_vec: torch.Tensor, hwf: tuple, near: float,
                       far: float, cfg: RenderConfig, rcfg: RefineConfig,
                       mask: torch.Tensor | None = None):
    """Refine one camera pose for rcfg.opt_iter Adam steps.

    init_pose: (3, 4) estimate in the dataset frame (the world rescale is
    applied inside). target_feat (h, w, C). ws_vec: [pose_scale,
    pose_scale2, mx, my, mz]. mask: optional (h, w) validity mask.
    Returns (refined pose (3, 4) in the dataset frame, losses
    (opt_iter,)), both detached; the loss of step i is that of the pose
    before step i's update, as in the JAX package."""
    dev = init_pose.device
    r = torch.zeros(3, device=dev, requires_grad=True)
    t = torch.zeros(3, device=dev, requires_grad=True)
    # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8, no eps_root
    opt = torch.optim.Adam([{"params": [r], "lr": rcfg.lr_r},
                            {"params": [t], "lr": rcfg.lr_t}],
                           betas=(0.9, 0.999), eps=1e-8)
    with torch.no_grad():       # the frozen field: packed once
        packed = model.pack_fused() if cfg.fused else None
    target_feat = target_feat.detach()
    losses = []
    for _ in range(rcfg.opt_iter):
        opt.zero_grad(set_to_none=True)
        _, nerf_pose = _pose_from(r, t, init_pose, ws_vec)
        _, fused = render_feature_image(model, nerf_pose, hist, hwf, near,
                                        far, cfg, fusion_bn=rcfg.fusion,
                                        packed=packed)
        if mask is not None:
            loss = masked_feature_cosine_loss(fused, target_feat, mask,
                                              per_pixel=rcfg.per_pixel)
        else:
            loss = feature_cosine_loss(fused, target_feat,
                                       per_pixel=rcfg.per_pixel)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        refined, _ = _pose_from(r, t, init_pose, ws_vec)
    return refined, torch.stack(losses)


def refine_poses_batch(model, init_poses, target_feats, hists,
                       ws: WorldSetup, hwf: tuple, cfg: RenderConfig,
                       rcfg: RefineConfig, masks=None):
    """Refine N cameras, one after another. Returns (refined (N, 3, 4),
    losses (N, opt_iter))."""
    ws_vec = ws.vec(device=init_poses.device)
    outs = [refine_pose_single(model, init_poses[i], target_feats[i],
                               hists[i], ws_vec, hwf, ws.near, ws.far, cfg,
                               rcfg,
                               mask=None if masks is None else masks[i])
            for i in range(init_poses.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
