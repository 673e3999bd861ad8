"""Mode-2 refinement: APR-weight optimisation, the paper's headline
DFNet + NeFeS50 configuration, and the same for every APR of the zoo;
port of nefes_tpu/refine/apr_opt.py (reference
script/dm/DFM_APR_refine.py).

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
lax.scan. Here refine_apr_single is a Python loop of opt_iter steps (the
CPU path, and the baseline on the card); the serving functions
(refine_apr_verified, refine_apr_verified_scanned) run it on a CPU tensor
and, on the card, replay one captured iteration (AprLoop,
refine/graph.py).

apr_kind names the APR's family (features/apr_loader.py APR_KINDS):
DFNet and the zoo's PoseNet (PoseNetRes34), PoseNetV2, EfficientNetB3,
MapNet and MsTransformer. MsTransformer converts its output by
dataset_type, on Cambridge with the scene's pose_avg (the stats (3, 4);
None: those the model was built with, its pose_avg_inv).
"""

from __future__ import annotations

import copy

import torch

from nefes_tpu_torch.features.apr_loader import APR_KINDS
from nefes_tpu_torch.features.mstransformer import (
    ems_pose_to_matrix, pose_avg_inverse,
)
from nefes_tpu_torch.geometry.se3 import (
    orthogonalize_rotation, orthogonalize_rotation_polar,
)
from nefes_tpu_torch.geometry.transforms import fix_coord_supp
from nefes_tpu_torch.refine import graph
from nefes_tpu_torch.refine.losses import (
    feature_cosine_loss, masked_feature_cosine_loss,
)
from nefes_tpu_torch.refine.pose_opt import (
    RefineConfig, clone_packed, on_card, refresh_packed_,
    render_feature_image,
)
from nefes_tpu_torch.render.renderer import RenderConfig
from nefes_tpu_torch.train.losses import psnr as psnr_fn
from nefes_tpu_torch.utils.image import resize_bicubic
from nefes_tpu_torch.utils.ssim import ssim

CROP = 10  # border crop (DFM_APR_refine.py:122-126)


def _crop(img: torch.Tensor) -> torch.Tensor:
    return img[CROP:-CROP, CROP:-CROP]


def _poses(kind: str, module, images: torch.Tensor, train_bn: bool,
           dataset_type: str, pose_avg) -> torch.Tensor:
    """(B, H, W, 3) images -> the APR's (B, 3, 4) poses before svd_reg.
    train_bn: BN on the batch's statistics (MsTransformer always runs on
    its running ones, as the JAX package calls it)."""
    if kind == "DFNet":
        _, pose12 = module(images, return_feature=False, return_pose=True,
                           train_bn=train_bn)
        return pose12.reshape(-1, 3, 4)
    if kind == "MsTransformer":
        inv = (module.pose_avg_inv if pose_avg is None
               else pose_avg_inverse(pose_avg).to(images.device))
        return ems_pose_to_matrix(module(images)["pose"], dataset_type, inv)
    return module(images, train=train_bn).reshape(-1, 3, 4)


def apr_pose_any(kind: str, module, image: torch.Tensor,
                 svd_reg: bool = True, freeze_bn: bool = True,
                 dataset_type: str = "7Scenes", pose_avg=None,
                 ortho=orthogonalize_rotation) -> torch.Tensor:
    """APR forward of any family: (H, W, 3) image -> (3, 4) pose (the
    per-type dispatch of inference_pose_regression,
    DFM_pose_refine.py:131-161). freeze_bn=False runs BN on the image's
    own statistics (the reference's un-frozen train() mode) without
    updating the running ones. ortho: the svd_reg orthogonalisation (the
    captured loop passes the polar iteration)."""
    pose = _poses(kind, module, image[None], not freeze_bn, dataset_type,
                  pose_avg)[0]
    return ortho(pose) if svd_reg else pose


def apr_pose(dfnet, image: torch.Tensor, svd_reg: bool = True,
             freeze_bn: bool = True,
             ortho=orthogonalize_rotation) -> torch.Tensor:
    """apr_pose_any for DFNet, whose pose branch has no BN: freeze_bn
    gives the same pose either way."""
    return apr_pose_any("DFNet", dfnet, image, svd_reg, freeze_bn,
                        ortho=ortho)


def apr_poses_batched(kind: str, module, images: torch.Tensor,
                      svd_reg: bool = True, freeze_bn: bool = True,
                      dataset_type: str = "7Scenes", pose_avg=None
                      ) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, 3, 4) APR poses (the JAX package's
    vmapped apr_pose_any, nefes_tpu/refine/apr_opt.py:94): one batched
    forward on running BN statistics, one forward an image on batch
    statistics (each image its own, as the vmap gives)."""
    _check_kind(kind)
    if not freeze_bn and kind != "MsTransformer":
        return torch.stack([apr_pose_any(kind, module, im, svd_reg, False,
                                         dataset_type, pose_avg)
                            for im in images])
    pose = _poses(kind, module, images, False, dataset_type, pose_avg)
    return orthogonalize_rotation(pose) if svd_reg else pose


def _check_kind(apr_kind: str) -> None:
    if apr_kind not in APR_KINDS:
        raise NotImplementedError(
            f"APR kind {apr_kind!r}: not one of {APR_KINDS} (NetVlad has no "
            "model to refine, direct_pose_model.py:166-168)")


def _own_pose_avg(kind: str, apr, pose_avg) -> None:
    """Give the APR's copy the scene's pose_avg (MsTransformer only), so
    that its iterations convert with the inverse computed here once."""
    if kind == "MsTransformer" and pose_avg is not None:
        apr.pose_avg_inv.copy_(pose_avg_inverse(pose_avg))


def _upsampled_loss(fused, rgb_img, tgt_crop, mask, H: int, W: int,
                    per_pixel: bool):
    """The render upsampled (bicubic) to the query's size and cropped:
    (the cosine loss against the cropped target, the cropped rgb)."""
    fused_up = _crop(resize_bicubic(fused[None], H, W)[0])
    rgb_up = resize_bicubic(rgb_img[None], H, W)[0]
    if mask is not None:
        loss = masked_feature_cosine_loss(fused_up, tgt_crop, _crop(mask),
                                          per_pixel=per_pixel)
    else:
        loss = feature_cosine_loss(fused_up, tgt_crop, per_pixel=per_pixel)
    return loss, _crop(rgb_up)


def refine_apr_single(model, dfnet, image: torch.Tensor,
                      target_feat: torch.Tensor, hist: torch.Tensor,
                      ws_vec: torch.Tensor, hwf_render: tuple,
                      hwf_full: tuple, near: float, far: float,
                      cfg: RenderConfig, rcfg: RefineConfig,
                      svd_reg: bool = True, mask: torch.Tensor | None = None,
                      freeze_bn: bool = True, apr_kind: str = "DFNet",
                      dataset_type: str = "7Scenes", pose_avg=None) -> dict:
    """Refine a copy of the APR `dfnet` (of family apr_kind) on ONE query
    image for rcfg.opt_iter Adam steps (learning rate rcfg.learning_rate,
    optax's defaults otherwise).

    image (H, W, 3); target_feat (H, W, C): full-size DFNet features of
    the query (extracted once outside); mask: optional (H, W) validity
    mask. `dfnet` is left untouched. Returns {refined_pose, initial_pose
    (3, 4), losses (opt_iter,), init_psnr, end_psnr, init_ssim, end_ssim},
    detached."""
    _check_kind(apr_kind)
    H, W, _ = hwf_full
    apr = copy.deepcopy(dfnet).requires_grad_(True)
    with torch.no_grad():
        _own_pose_avg(apr_kind, apr, pose_avg)
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
        pose = apr_pose_any(apr_kind, apr, image, svd_reg, freeze_bn,
                            dataset_type)
        rgb_img, fused = render_feature_image(
            model, fix_coord_supp(pose, ws_vec), hist, hwf_render, near, far,
            cfg, fusion_bn=rcfg.fusion, packed=packed)
        loss, rgb_crop = _upsampled_loss(fused, rgb_img, tgt_crop, mask,
                                         H, W, rcfg.per_pixel)
        # only the APR's gradients: the frozen field, exposure and fusion
        # weights take none, whatever their requires_grad
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            psnrs.append(psnr_fn(rgb_crop, img_crop))
            ssims.append(ssim(rgb_crop[None], img_crop[None]).mean())
        for p, g in zip(params, grads):
            # None where a weight does not reach the pose: Adam skips it,
            # as optax leaves a weight with zero gradients where it is
            p.grad = g
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        refined_pose = apr_pose_any(apr_kind, apr, image, svd_reg, True,
                                    dataset_type)
        initial_pose = apr_pose_any(apr_kind, dfnet, image, svd_reg, True,
                                    dataset_type, pose_avg)
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


def refine_apr_verified(model, dfnet, images, targets, hists, idx: int,
                        hist_idx: int, ws_vec, hwf_render: tuple,
                        hwf_full: tuple, near: float, far: float,
                        cfg: RenderConfig, rcfg: RefineConfig,
                        svd_reg: bool = True, masks=None,
                        freeze_bn: bool = True, apr_kind: str = "DFNet",
                        dataset_type: str = "7Scenes", pose_avg=None,
                        use_verification: bool = True,
                        verification_metric: str = "psnr_ssim"
                        ) -> torch.Tensor:
    """The serving step: refine frame `idx` of the staged batch (histogram
    `hist_idx`), apply the verification fail-safe, return the (3, 4)
    pose (the JAX package's one-launch step,
    nefes_tpu/refine/apr_opt.py:238). The eager loop on a CPU tensor, the
    captured one on the card."""
    run = refine_apr_captured if on_card(images) else refine_apr_single
    out = run(model, dfnet, images[idx], targets[idx], hists[hist_idx],
              ws_vec, hwf_render, hwf_full, near, far, cfg, rcfg,
              svd_reg=svd_reg, mask=None if masks is None else masks[idx],
              freeze_bn=freeze_bn, apr_kind=apr_kind,
              dataset_type=dataset_type, pose_avg=pose_avg)
    return (apply_verification(out, verification_metric)
            if use_verification else out["refined_pose"])


def refine_apr_verified_scanned(model, dfnet, images, targets, hists,
                                idxs, hist_idxs, ws_vec, hwf_render: tuple,
                                hwf_full: tuple, near: float, far: float,
                                cfg: RenderConfig, rcfg: RefineConfig,
                                svd_reg: bool = True, masks=None,
                                freeze_bn: bool = True,
                                apr_kind: str = "DFNet",
                                dataset_type: str = "7Scenes", pose_avg=None,
                                use_verification: bool = True,
                                verification_metric: str = "psnr_ssim"
                                ) -> torch.Tensor:
    """Frames idxs (histograms hist_idxs) one after another through
    refine_apr_verified (the JAX package's lax.scan over frames,
    nefes_tpu/refine/apr_opt.py:276). Returns (N, 3, 4)."""
    return torch.stack([refine_apr_verified(
        model, dfnet, images, targets, hists, int(i), int(hi), ws_vec,
        hwf_render, hwf_full, near, far, cfg, rcfg, svd_reg=svd_reg,
        masks=masks, freeze_bn=freeze_bn, apr_kind=apr_kind,
        dataset_type=dataset_type, pose_avg=pose_avg,
        use_verification=use_verification,
        verification_metric=verification_metric)
        for i, hi in zip(idxs, hist_idxs)])


# --- serving on the card: the captured iteration ---

class AprLoop:
    """Mode 2 on the card for one (model, APR and its family, render
    config, refine config, dataset type, shapes): one static copy of the
    APR whose state (weights and BN statistics) is reloaded from the APR
    in place each frame (the eager loop's deep copy), and one captured
    iteration of refine_apr_single. svd_reg orthogonalises by the polar
    iteration (se3.orthogonalize_rotation_polar): the SVD reads back to
    the host on the card."""

    name = "mode2"

    def __init__(self, model, dfnet, hwf_render: tuple,
                 hwf_full: tuple, near: float, far: float,
                 cfg: RenderConfig, rcfg: RefineConfig, svd_reg: bool,
                 freeze_bn: bool, target_channels: int, hist_shape,
                 has_mask: bool, device, apr_kind: str = "DFNet",
                 dataset_type: str = "7Scenes"):
        self.model, self.hwf_render, self.hwf_full = model, hwf_render, \
            hwf_full
        self.near, self.far, self.cfg, self.rcfg = near, far, cfg, rcfg
        self.svd_reg, self.freeze_bn = svd_reg, freeze_bn
        self.apr_kind, self.dataset_type = apr_kind, dataset_type
        H, W, _ = hwf_full
        z = dict(device=device)
        self.image = torch.zeros((H, W, 3), **z)
        self.target = torch.zeros((H, W, target_channels), **z)
        self.hist = torch.zeros(hist_shape, **z)
        self.mask = torch.zeros((H, W), **z) if has_mask else None
        self.ws_vec = torch.zeros(5, **z)
        self.apr = copy.deepcopy(dfnet).requires_grad_(True)
        self.params = list(self.apr.parameters())
        # refine_apr_single's Adam, bit for bit
        self.opt = graph.GraphAdam([(self.params, rcfg.learning_rate)],
                                   rcfg.opt_iter)
        self.losses, self.psnrs, self.ssims = (
            torch.zeros(rcfg.opt_iter, **z) for _ in range(3))
        self.it = torch.zeros(1, dtype=torch.int64, **z)
        with torch.no_grad():
            self.packed = (clone_packed(model.pack_fused()) if cfg.fused
                           else None)
        self.dfnet = None           # the APR the state is reset from
        self.graph = None

    def _pose(self, apr, freeze_bn, pose_avg=None):
        return apr_pose_any(self.apr_kind, apr, self.image, self.svd_reg,
                            freeze_bn, self.dataset_type, pose_avg,
                            ortho=orthogonalize_rotation_polar)

    def _step(self) -> None:
        H, W, _ = self.hwf_full
        pose = self._pose(self.apr, self.freeze_bn)
        rgb_img, fused = render_feature_image(
            self.model, fix_coord_supp(pose, self.ws_vec), self.hist,
            self.hwf_render, self.near, self.far, self.cfg,
            fusion_bn=self.rcfg.fusion, packed=self.packed)
        loss, rgb_crop = _upsampled_loss(fused, rgb_img, _crop(self.target),
                                         self.mask, H, W,
                                         self.rcfg.per_pixel)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        with torch.no_grad():
            img_crop = _crop(self.image)
            graph.record_(self.psnrs, self.it, psnr_fn(rgb_crop, img_crop))
            graph.record_(self.ssims, self.it,
                          ssim(rgb_crop[None], img_crop[None]).mean())
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step(self.it)
        with torch.no_grad():
            graph.record_(self.losses, self.it, loss)
            self.it.add_(1)

    @torch.no_grad()
    def _reset(self) -> None:
        for a, d in zip(self.apr.state_dict().values(),
                        self.dfnet.state_dict().values()):
            a.copy_(d)
        self.it.zero_()
        self.opt.zero_()

    def _release_grads(self) -> None:
        for p in self.params:
            p.grad = None

    def run(self, dfnet, image, target, hist, ws_vec, mask=None,
            pose_avg=None) -> dict:
        """One frame from dfnet's weights: refine_apr_single's dict."""
        self.dfnet = dfnet
        with torch.no_grad():
            if self.apr_kind == "MsTransformer":
                self.apr.pose_avg_inv.copy_(dfnet.pose_avg_inv)
                _own_pose_avg(self.apr_kind, self.apr, pose_avg)
            for buf, x in ((self.image, image), (self.target, target),
                           (self.hist, hist), (self.ws_vec, ws_vec),
                           (self.mask, mask)):
                if buf is not None:
                    buf.copy_(x)
            if self.packed is not None:
                refresh_packed_(self.packed, self.model.pack_fused())
        if self.graph is None:
            self.graph = graph.CapturedIteration(self._step, self._reset,
                                                 self._release_grads)
        self._reset()
        self.graph.replay(self.rcfg.opt_iter)
        with torch.no_grad():
            refined = self._pose(self.apr, True)
            initial = self._pose(dfnet, True, pose_avg)
        losses, psnrs, ssims = (b.clone() for b in (self.losses, self.psnrs,
                                                    self.ssims))
        return {"refined_pose": refined, "initial_pose": initial,
                "losses": losses, "init_psnr": psnrs[0],
                "end_psnr": psnrs[-1], "init_ssim": ssims[0],
                "end_ssim": ssims[-1]}


def refine_apr_captured(model, dfnet, image: torch.Tensor,
                        target_feat: torch.Tensor, hist: torch.Tensor,
                        ws_vec: torch.Tensor, hwf_render: tuple,
                        hwf_full: tuple, near: float, far: float,
                        cfg: RenderConfig, rcfg: RefineConfig,
                        svd_reg: bool = True,
                        mask: torch.Tensor | None = None,
                        freeze_bn: bool = True, apr_kind: str = "DFNet",
                        dataset_type: str = "7Scenes", pose_avg=None
                        ) -> dict:
    """refine_apr_single through the cached AprLoop (CUDA tensors)."""
    _check_kind(apr_kind)
    key = ("mode2", id(model), id(dfnet), apr_kind, dataset_type,
           hwf_render, hwf_full, float(near), float(far), cfg, rcfg,
           svd_reg, freeze_bn, target_feat.shape[-1], tuple(hist.shape),
           mask is not None, str(image.device))
    loop = graph.cached(key, (model, dfnet), lambda: AprLoop(
        model, dfnet, hwf_render, hwf_full, near, far, cfg, rcfg, svd_reg,
        freeze_bn, target_feat.shape[-1], tuple(hist.shape),
        mask is not None, image.device, apr_kind, dataset_type))
    return loop.run(dfnet, image, target_feat, hist, ws_vec, mask, pose_avg)


def refine_apr_batch(model, dfnet, images, targets, hists, ws_vec,
                     hwf_render: tuple, hwf_full: tuple, near: float,
                     far: float, cfg: RenderConfig, rcfg: RefineConfig,
                     svd_reg: bool = True, masks=None,
                     freeze_bn: bool = True, apr_kind: str = "DFNet",
                     dataset_type: str = "7Scenes", pose_avg=None) -> dict:
    """Refine B query frames one after another, each from a fresh copy of
    the APR. Returns refine_apr_single's dict with a leading B on every
    entry."""
    outs = [refine_apr_single(
        model, dfnet, images[i], targets[i], hists[i], ws_vec, hwf_render,
        hwf_full, near, far, cfg, rcfg, svd_reg=svd_reg,
        mask=None if masks is None else masks[i], freeze_bn=freeze_bn,
        apr_kind=apr_kind, dataset_type=dataset_type, pose_avg=pose_avg)
        for i in range(images.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
