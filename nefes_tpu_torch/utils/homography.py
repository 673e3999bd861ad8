"""Homography warp suite (legacy DFNet feature-training dependency); port
of nefes_tpu/utils/homography.py.

Reference: script/utils/utils.py:158-528 — warp_points,
inv_warp_image_batch (grid_sample), compute_valid_mask,
sample_homography_np, create_warped_img. torch for the differentiable
warp path, on the image's device; numpy for the random homography
sampling (the JAX package's draws, so that one seed gives both packages
the same homographies); cv2.getPerspectiveTransform is replaced by a
direct 8x8 DLT solve.

grid_sample is the JAX package's masked gather rather than
torch.nn.functional.grid_sample: each of the four corners outside the
image counts zero on its own, and nearest rounds half to even
(jnp.round, torch.round), so the two packages agree on the border and at
exact half pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def warp_points(points: torch.Tensor,
                homographies: torch.Tensor) -> torch.Tensor:
    """points (N, 2[x,y]); homographies (3, 3) or (B, 3, 3).
    Returns (N, 2) or (B, N, 2) (reference utils.py:158-185)."""
    single = homographies.dim() == 2
    H = homographies[None] if single else homographies
    pts = torch.cat([points.float(),
                     torch.ones((points.shape[0], 1), device=points.device)],
                    dim=1)
    warped = torch.einsum("bij,nj->bni", H.float(), pts)
    warped = warped[..., :2] / warped[..., 2:]
    return warped[0] if single else warped


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """torch.F.grid_sample(align_corners=True, padding_mode='zeros')
    semantics. img: (B, H, W, C) NHWC; coords: (B, Ho, Wo, 2) in [-1,1]
    (x, y)."""
    B, H, W, C = img.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    flat = img.reshape(B, H * W, C)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, -1)
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return g.reshape(*ix.shape, C) * inb[..., None]

    if mode == "nearest":
        return gather(torch.round(x).long(), torch.round(y).long())

    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    return (gather(x0, y0) * (1 - fx) * (1 - fy)
            + gather(x0 + 1, y0) * fx * (1 - fy)
            + gather(x0, y0 + 1) * (1 - fx) * fy
            + gather(x0 + 1, y0 + 1) * fx * fy)


def inv_warp_image_batch(img: torch.Tensor, mat_homo_inv: torch.Tensor,
                         mode: str = "bilinear") -> torch.Tensor:
    """Inverse-warp (B, H, W, C) images by (B, 3, 3) homographies acting
    on [-1, 1]-normalised coords (reference utils.py:187-221)."""
    if img.dim() == 3:
        img = img[None]
    if mat_homo_inv.dim() == 2:
        mat_homo_inv = mat_homo_inv[None]
    B, H, W, C = img.shape
    xs = torch.linspace(-1.0, 1.0, W, device=img.device)
    ys = torch.linspace(-1.0, 1.0, H, device=img.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")          # (H, W)
    cells = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    src = warp_points(cells, mat_homo_inv.to(img.device))   # (B, HW, 2)
    return grid_sample(img, src.reshape(B, H, W, 2), mode=mode)


def compute_valid_mask(image_shape: tuple, inv_homography: torch.Tensor,
                       erosion_radius: int = 0) -> torch.Tensor:
    """(B, H, W) mask of non-border pixels after warping
    (reference utils.py:223-248); the erosion runs in cv2 on the host."""
    if inv_homography.dim() == 2:
        inv_homography = inv_homography[None]
    B = inv_homography.shape[0]
    H, W = image_shape
    ones = torch.ones((B, H, W, 1), device=inv_homography.device)
    mask = inv_warp_image_batch(ones, inv_homography, mode="nearest")[..., 0]
    if erosion_radius > 0:
        import cv2
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                           (erosion_radius * 2,) * 2)
        eroded = np.stack([cv2.erode(m, kernel, iterations=1)
                           for m in mask.cpu().numpy()])
        mask = torch.from_numpy(eroded).to(mask.device)
    return mask


def four_point_homography(pts1: np.ndarray, pts2: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform replacement: the homography mapping
    pts1 -> pts2 ((4, 2) each) via the standard 8x8 DLT solve."""
    A, b = [], []
    for (x, y), (u, v) in zip(pts1, pts2):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.array(A, np.float64), np.array(b, np.float64))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def _truncnorm(rng: np.random.Generator, std_trunc: float, loc: float,
               scale: float, size: int) -> np.ndarray:
    """Truncated normal by rejection (scipy-free; same distribution as
    scipy.stats.truncnorm(-s, s, loc, scale))."""
    out = rng.normal(0.0, 1.0, size)
    for _ in range(100):
        bad = np.abs(out) > std_trunc
        if not bad.any():
            break
        out[bad] = rng.normal(0.0, 1.0, bad.sum())
    return loc + np.clip(out, -std_trunc, std_trunc) * scale


def sample_homography_np(shape, shift: float = 0, perspective: bool = True,
                         scaling: bool = True, rotation: bool = True,
                         translation: bool = True, n_scales: int = 5,
                         n_angles: int = 25,
                         scaling_amplitude: float = 0.1,
                         perspective_amplitude_x: float = 0.1,
                         perspective_amplitude_y: float = 0.1,
                         patch_ratio: float = 0.5,
                         max_angle: float = math.pi / 2,
                         allow_artifacts: bool = False,
                         translation_overflow: float = 0.0,
                         rng: np.random.Generator | None = None
                         ) -> np.ndarray:
    """Random valid homography between a centred patch and its perturbed
    projection (reference utils.py:408-519, SuperPoint-style)."""
    rng = rng or np.random.default_rng()
    shape = np.asarray(shape, np.float64)
    std_trunc = 2.0

    pts1 = np.stack([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    margin = (1 - patch_ratio) / 2
    pts2 = margin + np.array([[0, 0], [0, patch_ratio],
                              [patch_ratio, patch_ratio],
                              [patch_ratio, 0]], np.float64)

    if perspective:
        if not allow_artifacts:
            perspective_amplitude_x = min(perspective_amplitude_x, margin)
            perspective_amplitude_y = min(perspective_amplitude_y, margin)
        pd = _truncnorm(rng, std_trunc, 0, perspective_amplitude_y / 2, 1)
        hl = _truncnorm(rng, std_trunc, 0, perspective_amplitude_x / 2, 1)
        hr = _truncnorm(rng, std_trunc, 0, perspective_amplitude_x / 2, 1)
        pts2 += np.array([[hl, pd], [hl, -pd], [hr, pd],
                          [hr, -pd]]).squeeze()

    if scaling:
        scales = np.concatenate([
            [1.0], _truncnorm(rng, std_trunc, 1, scaling_amplitude / 2,
                              n_scales)])
        center = pts2.mean(axis=0, keepdims=True)
        scaled = ((pts2 - center)[None] * scales[:, None, None]) + center
        if allow_artifacts:
            valid = np.arange(n_scales)
        else:
            ok = ((scaled >= 0.0) & (scaled < 1.0)).all(axis=(1, 2))
            valid = np.where(ok)[0]
        pts2 = scaled[valid[rng.integers(len(valid))]]

    if translation:
        t_min = pts2.min(axis=0)
        t_max = (1 - pts2).min(axis=0)
        if allow_artifacts:
            t_min = t_min + translation_overflow
            t_max = t_max + translation_overflow
        pts2 += np.array([rng.uniform(-t_min[0], t_max[0]),
                          rng.uniform(-t_min[1], t_max[1])])

    if rotation:
        angles = np.concatenate([
            np.linspace(-max_angle, max_angle, n_angles), [0.0]])
        center = pts2.mean(axis=0, keepdims=True)
        rot = np.stack([np.cos(angles), -np.sin(angles), np.sin(angles),
                        np.cos(angles)], axis=1).reshape(-1, 2, 2)
        rotated = (pts2 - center)[None] @ rot + center
        if allow_artifacts:
            valid = np.arange(n_angles)
        else:
            ok = ((rotated >= 0.0) & (rotated < 1.0)).all(axis=(1, 2))
            valid = np.where(ok)[0]
        pts2 = rotated[valid[rng.integers(len(valid))]]

    size = shape[::-1]                                   # [W, H]
    pts1 = pts1 * size[None]
    pts2 = pts2 * size[None]
    return four_point_homography(pts1 + shift, pts2 + shift)


def create_warped_img(img: torch.Tensor, batch_size: int,
                      rng: np.random.Generator | None = None):
    """Warp a batch with ONE shared random homography sampled in the
    [-1, 1] coordinate frame (reference utils.py:520-558). Returns (the
    warped (B, H, W, C) images, the homographies (batch_size, 3, 3) f32 on
    img's device)."""
    h = sample_homography_np(
        np.array([2, 2]), shift=-1, perspective=True, scaling=True,
        rotation=True, translation=True, n_scales=5, n_angles=25,
        scaling_amplitude=0.1, perspective_amplitude_x=0.2,
        perspective_amplitude_y=0.2, patch_ratio=0.8,
        max_angle=math.pi / 6, allow_artifacts=False, rng=rng)
    homos = torch.as_tensor(np.stack([h] * batch_size), dtype=torch.float32,
                            device=img.device)
    return inv_warp_image_batch(img, homos, mode="bilinear"), homos
