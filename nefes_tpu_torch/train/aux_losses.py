"""Auxiliary regularisation losses; port of nefes_tpu/train/aux_losses.py
(reference script/models/losses.py:175-366): TV on density over a random
alpha sub-cube, L1 on hash-grid embeddings, Cauchy sigma sparsity,
scale-invariant DPT depth losses and edge-aware depth smoothness.

The TV cube's corners are given (a test passes those the JAX package drew
from its key) or drawn from a torch.Generator; the density and encoder
closures are plain callables (xyz (N, 3) in [0, 1] -> sigma (N,) /
embedding). Medians are the mean of the two middle values, as
jnp.median's, not torch.median's lower one.
"""

from __future__ import annotations

import torch

from nefes_tpu_torch.render.sampling import base_generator

TV_DELTAS = 9.5238e-02   # reference magic number (losses.py:231)


def _tv3d(vol: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Sum of squared forward differences along the 3 spatial axes of a
    (X, Y, Z, C) volume (compute_TV_loss, losses.py:219-223)."""
    tv_x = torch.sum((vol[1:] - vol[:-1]) ** 2)
    tv_y = torch.sum((vol[:, 1:] - vol[:, :-1]) ** 2)
    tv_z = torch.sum((vol[:, :, 1:] - vol[:, :, :-1]) ** 2)
    return torch.sum((tv_x + tv_y + tv_z) / denom) + 1e-8


def tv_corners(gen: torch.Generator | None,
               sample_resolution=(512, 256, 512)) -> torch.Tensor:
    """The TV cube's three corner indices, (3,) int64 on gen's device
    (the CPU without a generator): each uniform in [0, res - res // 10);
    a RowShard draws from its generator."""
    gen = base_generator(gen)
    dev = gen.device if gen is not None else "cpu"
    return torch.stack([
        torch.randint(0, s - s // 10, (), generator=gen, device=dev)
        for s in sample_resolution])


def total_variation_loss(density_coarse, density_fine, corners=None,
                         gen: torch.Generator | None = None,
                         sample_resolution=(512, 256, 512),
                         deltas: float = TV_DELTAS) -> torch.Tensor:
    """TV smoothness on alphas over a 10 %-side sub-cube
    (losses.py:226-265) whose lowest grid indices are `corners` (3,),
    drawn from `gen` when None. density_*: callable xyz (N, 3) in [0, 1]
    -> sigma (N,)."""
    if corners is None:
        corners = tv_corners(gen, sample_resolution)
    corners = torch.as_tensor(corners)
    dev = corners.device
    res = torch.tensor(sample_resolution, dtype=torch.float32, device=dev)
    cube = tuple(int(s // 10) for s in sample_resolution)
    ax = [corners[i] + torch.arange(cube[i], device=dev) for i in range(3)]
    grid = torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1)
    coords = (grid / (res - 1.0)).reshape(-1, 3)
    denom = torch.tensor(cube, dtype=torch.float32, device=dev)

    out = []
    for density in (density_coarse, density_fine):
        sigma = density(coords)
        alpha = 1.0 - torch.exp(-deltas * sigma)
        out.append(_tv3d(alpha.reshape(*cube, 1), denom.to(alpha.device)))
    return out[0] + out[1]


def embeddings_l1_loss(encoder_coarse, encoder_fine,
                       sample_resolution: int = 16) -> torch.Tensor:
    """Mean |.| of hash-grid embeddings over a dense [0, 1]³ grid
    (embeddings_L1_loss, losses.py:284-314)."""
    idx = torch.arange(sample_resolution, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1)
    coords = (grid / (sample_resolution - 1.0)).reshape(-1, 3)
    loss = 0.0
    for enc in (encoder_coarse, encoder_fine):
        loss = loss + torch.mean(torch.abs(enc(coords)))
    return loss


def sigma_sparsity_loss(sigmas: torch.Tensor) -> torch.Tensor:
    """Cauchy sparsity, per-sample sum over the trailing axis
    (losses.py:277-279)."""
    return torch.sum(torch.log(1.0 + 2.0 * sigmas ** 2), dim=-1)


def sigma_sparsity_loss2(sigmas: torch.Tensor,
                         lambda_u: float = 0.01) -> torch.Tensor:
    return lambda_u * torch.mean(sigmas)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of all of x: the middle value, or the mean of the two
    middle ones."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _shift_scale_normalize(depth: torch.Tensor) -> torch.Tensor:
    t = _median(depth)
    s = torch.mean(torch.abs(depth - t))
    return (depth - t) / (s + 1e-12)


def compute_depth_loss(pred_depth: torch.Tensor,
                       gt_depth: torch.Tensor) -> torch.Tensor:
    """Scale/shift-invariant MSE between NeRF depth and DPT depth
    (losses.py:175-191)."""
    return torch.mean((_shift_scale_normalize(pred_depth)
                       - _shift_scale_normalize(gt_depth)) ** 2)


def depth_loss_dpt(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                   weight: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) variant with optional pixel weights (losses.py:344-366)."""
    pn = _shift_scale_normalize(pred_depth)
    gn = _shift_scale_normalize(gt_depth)
    if weight is None:
        return torch.mean((pn - gn) ** 2)
    per = (pn - gn) ** 2 * weight
    return per.sum() / (weight.sum() + 1e-8)


def compute_smooth_loss(tgt_depth: torch.Tensor,
                        tgt_img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of a disparity/depth map (losses.py:316-341),
    in the JAX package's NHWC layout: depth (B, H, W, 1), img (B, H, W, 3)
    (the reference is NCHW; same math)."""
    mean_disp = torch.mean(tgt_depth, dim=(1, 2), keepdim=True)
    disp = tgt_depth / (mean_disp + 1e-7)

    grad_disp_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    grad_img_x = torch.mean(torch.abs(tgt_img[:, :, :-1] - tgt_img[:, :, 1:]),
                            dim=-1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(tgt_img[:, :-1] - tgt_img[:, 1:]),
                            dim=-1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return torch.mean(grad_disp_x) + torch.mean(grad_disp_y)
