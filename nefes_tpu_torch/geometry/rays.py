"""Pinhole ray generation (OpenGL convention); port of
nefes_tpu/geometry/rays.py:get_rays and get_ray_at."""

from __future__ import annotations

import torch


def get_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """Rays for every pixel of an H×W image.

    c2w: (..., 3, 4) camera-to-world. Returns (rays_o, rays_d), each
    (..., H, W, 3). Camera-frame direction ((i - W/2)/f, -(j - H/2)/f, -1).
    """
    kw = dict(dtype=c2w.dtype, device=c2w.device)
    j, i = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], dim=-1)          # (H, W, 3)
    rays_d = torch.einsum("hwc,...rc->...hwr", dirs, c2w[..., :3, :3])
    rays_o = c2w[..., None, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_ray_at(px: torch.Tensor, py: torch.Tensor, focal: float, H: int,
               W: int, c2w: torch.Tensor):
    """Rays at explicit pixel coordinates px, py (..., N) under poses c2w
    (..., 3, 4) (the random-ray and patch training batches). Returns
    (rays_o, rays_d), each (..., N, 3)."""
    dirs = torch.stack([(px - W * 0.5) / focal, -(py - H * 0.5) / focal,
                        -torch.ones_like(px)], dim=-1)          # (..., N, 3)
    rays_d = torch.einsum("...nc,...rc->...nr", dirs, c2w[..., :3, :3])
    rays_o = c2w[..., None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d
