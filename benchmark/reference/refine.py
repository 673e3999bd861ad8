"""Plain reference of one refinement frame (DFM_APR_refine.py and
DFM_pose_refine.py of the NeFeS repository): mode 2 refines a copy of
the APR's weights, mode 3 an SE(3) delta on the APR's pose, each for
`iters` Adam steps on the DFM cosine loss between the rendered, fused
features and the query's DFNet features. torch.optim.Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8)."""

from __future__ import annotations

import copy

import torch

from benchmark.reference import nefes

CROP = 10


def _crop(x):
    return x[CROP:-CROP, CROP:-CROP]


def mode2(field, apr, apr_pose, feat_net, image, hist, ws_vec, hwf_render,
          hwf_full, near, far, n_c, n_f, lr, iters) -> dict:
    """apr_pose(module, image (H, W, 3)) -> (3, 4). Returns the losses,
    PSNRs and SSIMs of each step (before its update), the initial,
    refined and verified poses."""
    H, W, _ = hwf_full
    with torch.no_grad():
        target = _crop(feat_net.features(image[None], H, W)[0])
        initial = apr_pose(apr, image)
    net = copy.deepcopy(apr).requires_grad_(True)
    params = [p for p in net.parameters()]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    img_crop = _crop(image)
    losses, psnrs, ssims = [], [], []
    for _ in range(iters):
        pose = apr_pose(net, image)
        rgb, fused = nefes.render_feature_image(
            field, nefes.fix_coord_supp(pose, ws_vec), hist, hwf_render,
            near, far, n_c, n_f)
        loss = nefes.cosine_loss(_crop(nefes.resize_bicubic(fused, H, W)),
                                 target)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            rgb_up = _crop(nefes.resize_bicubic(rgb, H, W))
            psnrs.append(float(nefes.psnr(rgb_up, img_crop)))
            ssims.append(float(nefes.ssim_mean(rgb_up, img_crop)))
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        refined = apr_pose(net, image)
    retreat = psnrs[-1] < psnrs[0] or ssims[-1] < ssims[0]
    return {"losses": losses, "psnrs0": psnrs[0], "psnrs-1": psnrs[-1],
            "ssims0": ssims[0], "ssims-1": ssims[-1],
            "initial": initial, "refined": refined,
            "verified": initial if retreat else refined}


def mode3(field, apr, apr_pose, feat_net, image, hist, ws_vec, hwf_render,
          near, far, n_c, n_f, lr_r, lr_t, iters) -> dict:
    """The SE(3) delta refinement from the APR's pose, against the query's
    features at the render's size. Returns the losses and the initial
    and refined poses."""
    h, w, _ = hwf_render
    with torch.no_grad():
        target = feat_net.features(image[None], h, w)[0]
        initial = apr_pose(apr, image)
    dev = image.device
    r = torch.zeros(3, device=dev, requires_grad=True)
    t = torch.zeros(3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([{"params": [r], "lr": lr_r},
                            {"params": [t], "lr": lr_t}],
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        pose = nefes.learn_pose(r, t, initial)
        _, fused = nefes.render_feature_image(
            field, nefes.fix_coord_supp(pose, ws_vec), hist, hwf_render,
            near, far, n_c, n_f)
        loss = nefes.cosine_loss(fused, target)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        refined = nefes.learn_pose(r, t, initial)
    return {"losses": losses, "initial": initial, "refined": refined}


@torch.no_grad()
def pose_loss(mode, field, feat_net, image, hist, pose34, ws_vec, hwf_render,
              hwf_full, near, far, n_c, n_f) -> float:
    """The DFM loss the reference gives a pose of the query: mode 2 at the
    query's size (upsampled, cropped), mode 3 at the render's."""
    _, fused = nefes.render_feature_image(
        field, nefes.fix_coord_supp(pose34, ws_vec), hist, hwf_render, near,
        far, n_c, n_f)
    if mode == 2:
        H, W, _ = hwf_full
        target = _crop(feat_net.features(image[None], H, W)[0])
        return float(nefes.cosine_loss(
            _crop(nefes.resize_bicubic(fused, H, W)), target))
    h, w, _ = hwf_render
    return float(nefes.cosine_loss(fused,
                                   feat_net.features(image[None], h, w)[0]))


def dfnet_pose(net, image):
    return net.pose(image[None])[0]
