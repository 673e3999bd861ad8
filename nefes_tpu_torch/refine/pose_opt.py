"""Mode-3 refinement: explicit SE(3) pose-delta optimisation; port of
nefes_tpu/refine/pose_opt.py (reference script/dm/DFM_pose_refine.py:
290-453).

Per iteration: pose = SE3.exp([t, r]) ∘ init -> fix_coord_supp world
rescale -> render at H/tinyscale -> exposure affine -> FusionNet (batch
statistics by default) -> cosine feature loss against the target -> Adam
step with lr_r on r and lr_t on t. The JAX package compiles the loop as
one lax.scan. Here refine_pose_single is a Python loop of opt_iter steps
(the CPU path, and the baseline on the card); the serving functions
(refine_pose_indexed, refine_poses_scanned) run it on a CPU tensor and,
on the card, replay one captured iteration (PoseLoop, refine/graph.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from nefes_tpu_torch.geometry.se3 import learn_pose
from nefes_tpu_torch.geometry.transforms import WorldSetup, fix_coord_supp
from nefes_tpu_torch.refine import graph
from nefes_tpu_torch.refine.losses import (
    feature_cosine_loss, masked_feature_cosine_loss,
)
from nefes_tpu_torch.render.renderer import RenderConfig, render_image


@dataclass(frozen=True)
class RefineConfig:
    opt_iter: int = 50
    lr_r: float = 0.01
    lr_t: float = 0.1
    tinyscale: float = 4.0        # render scale H/tinyscale (the CLI's)
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


def _feature_loss(fused, target, mask, per_pixel: bool) -> torch.Tensor:
    if mask is not None:
        return masked_feature_cosine_loss(fused, target, mask,
                                          per_pixel=per_pixel)
    return feature_cosine_loss(fused, target, per_pixel=per_pixel)


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
        loss = _feature_loss(fused, target_feat, mask, rcfg.per_pixel)
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


# --- serving on the card: the captured iteration ---

def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (serve through the captured loop), False for
    a CPU one (the eager loop); other devices are refused."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no refinement on device {x.device}")
    return x.device.type == "cuda"


def clone_packed(packed):
    """A private copy of model.pack_fused()'s (coarse, fine) for a loop's
    static weights."""
    return tuple(dataclasses.replace(
        p, weights={k: v.clone() for k, v in p.weights.items()},
        w=p.w.clone(), wt=p.wt.clone(), b=p.b.clone()) for p in packed)


def refresh_packed_(static, packed) -> None:
    """Copy a fresh pack_fused() into a loop's static copy, in place."""
    for s, p in zip(static, packed):
        for k, v in p.weights.items():
            s.weights[k].copy_(v)
        for name in ("w", "wt", "b"):
            getattr(s, name).copy_(getattr(p, name))


class PoseLoop:
    """Mode 3 on the card for one (model, render config, refine config,
    shapes): static buffers and one captured iteration of
    refine_pose_single, reused by every frame."""

    name = "mode3"

    def __init__(self, model, hwf: tuple, near: float, far: float,
                 cfg: RenderConfig, rcfg: RefineConfig, target_shape,
                 hist_shape, has_mask: bool, device):
        self.model, self.hwf, self.near, self.far = model, hwf, near, far
        self.cfg, self.rcfg = cfg, rcfg
        z = dict(device=device)
        self.init = torch.zeros((3, 4), **z)
        self.target = torch.zeros(target_shape, **z)
        self.hist = torch.zeros(hist_shape, **z)
        self.mask = torch.zeros(target_shape[:2], **z) if has_mask else None
        self.ws_vec = torch.zeros(5, **z)
        self.r = torch.zeros(3, requires_grad=True, **z)
        self.t = torch.zeros(3, requires_grad=True, **z)
        # refine_pose_single's Adam, bit for bit
        self.opt = graph.GraphAdam([([self.r], rcfg.lr_r),
                                    ([self.t], rcfg.lr_t)], rcfg.opt_iter)
        self.losses = torch.zeros(rcfg.opt_iter, **z)
        self.it = torch.zeros(1, dtype=torch.int64, **z)
        with torch.no_grad():
            self.packed = (clone_packed(model.pack_fused()) if cfg.fused
                           else None)
        self.graph = None

    def _step(self) -> None:
        _, nerf_pose = _pose_from(self.r, self.t, self.init, self.ws_vec)
        _, fused = render_feature_image(
            self.model, nerf_pose, self.hist, self.hwf, self.near, self.far,
            self.cfg, fusion_bn=self.rcfg.fusion, packed=self.packed)
        loss = _feature_loss(fused, self.target, self.mask,
                             self.rcfg.per_pixel)
        loss.backward()
        self.opt.step(self.it)
        with torch.no_grad():
            graph.record_(self.losses, self.it, loss)
            self.it.add_(1)

    def _release_grads(self) -> None:
        self.r.grad = self.t.grad = None

    @torch.no_grad()
    def _reset(self) -> None:
        self.r.zero_()
        self.t.zero_()
        self.it.zero_()
        self.opt.zero_()

    def run(self, init_pose, target, hist, ws_vec, mask=None):
        """One frame: (refined pose (3, 4), losses (opt_iter,)), as
        refine_pose_single returns them."""
        with torch.no_grad():
            for buf, x in ((self.init, init_pose), (self.target, target),
                           (self.hist, hist), (self.ws_vec, ws_vec),
                           (self.mask, mask)):
                if buf is not None:
                    buf.copy_(x)
            if self.packed is not None:
                refresh_packed_(self.packed, self.model.pack_fused())
        if self.graph is None:
            self.graph = graph.CapturedIteration(
                self._step, self._reset, self._release_grads)
        self._reset()
        self.graph.replay(self.rcfg.opt_iter)
        with torch.no_grad():
            refined, _ = _pose_from(self.r, self.t, self.init, self.ws_vec)
        return refined, self.losses.clone()


def refine_pose_captured(model, init_pose: torch.Tensor,
                         target_feat: torch.Tensor, hist: torch.Tensor,
                         ws_vec: torch.Tensor, hwf: tuple, near: float,
                         far: float, cfg: RenderConfig, rcfg: RefineConfig,
                         mask: torch.Tensor | None = None):
    """refine_pose_single through the cached PoseLoop (CUDA tensors)."""
    key = ("mode3", id(model), hwf, float(near), float(far), cfg, rcfg,
           tuple(target_feat.shape), tuple(hist.shape), mask is not None,
           str(init_pose.device))
    loop = graph.cached(key, (model,), lambda: PoseLoop(
        model, hwf, near, far, cfg, rcfg, tuple(target_feat.shape),
        tuple(hist.shape), mask is not None, init_pose.device))
    return loop.run(init_pose, target_feat, hist, ws_vec, mask)


def refine_pose_indexed(model, init_poses, target_feats, hists, idx: int,
                        ws_vec: torch.Tensor, hwf: tuple, near: float,
                        far: float, cfg: RenderConfig, rcfg: RefineConfig,
                        masks=None) -> torch.Tensor:
    """The mode-3 serving step over a scene's staged frames: refine frame
    idx, return its (3, 4) pose (the JAX package's one-launch step,
    nefes_tpu/refine/pose_opt.py:191). The eager loop on a CPU tensor,
    the captured one on the card."""
    args = (model, init_poses[idx], target_feats[idx], hists[idx], ws_vec,
            hwf, near, far, cfg, rcfg)
    mask = None if masks is None else masks[idx]
    run = refine_pose_captured if on_card(init_poses) else refine_pose_single
    return run(*args, mask=mask)[0]


def refine_poses_scanned(model, init_poses, target_feats, hists,
                         ws: WorldSetup, hwf: tuple, cfg: RenderConfig,
                         rcfg: RefineConfig, masks=None) -> torch.Tensor:
    """N frames one after another through refine_pose_indexed, at ws's
    near and far (the JAX package's lax.scan over frames,
    nefes_tpu/refine/pose_opt.py:211). Returns (N, 3, 4)."""
    ws_vec = ws.vec(device=init_poses.device)
    return torch.stack([
        refine_pose_indexed(model, init_poses, target_feats, hists, i,
                            ws_vec, hwf, ws.near, ws.far, cfg, rcfg,
                            masks=masks)
        for i in range(init_poses.shape[0])])
