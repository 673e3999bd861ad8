"""Legacy DFM/feature-training utilities; port of
nefes_tpu/refine/legacy_train.py.

Reference: script/feature/misc.py:206-765 — the toolbox the original
DFNet feature training used: triplet-loss family (incl. in-triplet hard
negative mining), masked MSE, random pose perturbation for synthetic
views, whole-set NeRF-W rendering, and the multi-option validation-loss
evaluator. The losses are torch on their inputs' device; the
hard-negative variants choose their branch on tensors (torch.where, an
index into the stacked branch losses), with no host read, so they stay
capturable and the gradient flows through the chosen branch only. The
pose perturbations are numpy, with the JAX package's draws.
"""

from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------------
# triplet family (torch TripletMarginLoss semantics: p=2 pairwise
# distance along the LAST axis + eps, mean over everything else)
# ----------------------------------------------------------------------

_EPS = 1e-6


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum((a - b + _EPS) ** 2, dim=-1))


def triplet_margin_loss(anchor, positive, negative,
                        margin: float = 1.0) -> torch.Tensor:
    """nn.TripletMarginLoss(margin, reduction='mean')."""
    d_ap = _pairwise_dist(anchor, positive)
    d_an = _pairwise_dist(anchor, negative)
    return torch.mean(torch.clamp_min(d_ap - d_an + margin, 0.0))


def triplet_loss(f1, f2, margin: float = 1.0) -> torch.Tensor:
    """Negatives = batch roll of f2 (misc.py:431-446). f*: (L, B, ...)."""
    return triplet_margin_loss(f1, f2, torch.roll(f2, 1, dims=1), margin)


def triplet_loss_hard_negative_mining(f1, f2,
                                      margin: float = 1.0) -> torch.Tensor:
    """In-triplet anchor swap (misc.py:447-474, BMVC'16 §3.3)."""
    anchor, positive = f1, f2
    anchor_neg = torch.roll(f1, 1, dims=1)
    negative = torch.roll(f2, 1, dims=1)
    case1 = torch.mean((anchor - negative) ** 2)
    case2 = torch.mean((positive - anchor_neg) ** 2)
    l1 = triplet_margin_loss(anchor, positive, negative, margin)
    l2 = triplet_margin_loss(positive, anchor, anchor_neg, margin)
    return torch.where(case1 < case2, l1, l2)


def triplet_loss_hard_negative_mining_plus(f1, f2,
                                           margin: float = 1.0
                                           ) -> torch.Tensor:
    """4-case variant (misc.py:475-528). Accepts (L, B, ...) [roll axis 1]
    or (B, ...) [roll axis 0]."""
    axis = 1 if f1.dim() == 5 else 0
    anchor, positive = f1, f2
    anchor_neg = torch.roll(f1, 1, dims=axis)
    negative = torch.roll(f2, 1, dims=axis)
    cases = torch.stack([
        torch.mean((anchor - negative) ** 2),
        torch.mean((positive - anchor_neg) ** 2),
        torch.mean((anchor - anchor_neg) ** 2),
        torch.mean((positive - negative) ** 2),
    ])
    losses = torch.stack([
        triplet_margin_loss(anchor, positive, negative, margin),
        triplet_margin_loss(positive, anchor, anchor_neg, margin),
        triplet_margin_loss(anchor, positive, anchor_neg, margin),
        triplet_margin_loss(positive, anchor, negative, margin),
    ])
    return losses[torch.argmin(cases)]


def masked_mse_loss(f1: torch.Tensor, f2: torch.Tensor,
                    valid_mask: torch.Tensor) -> torch.Tensor:
    """MSE over valid pixels only (misc.py:359-388). f*: (N, H, W, C)
    NHWC; valid_mask: (N, H, W) — frame 0's mask selects pixels for the
    whole batch, as the reference does."""
    m = (valid_mask[0].reshape(-1) > 0).to(f1.dtype)           # (H*W,)
    n, h, w, c = f1.shape
    a = f1.reshape(n, h * w, c) * m[None, :, None]
    b = f2.reshape(n, h * w, c) * m[None, :, None]
    denom = torch.clamp_min(m.sum() * n * c, 1.0)
    return torch.sum((a - b) ** 2) / denom


# ----------------------------------------------------------------------
# pose perturbation (synthetic virtual views; misc.py:594-677)
# ----------------------------------------------------------------------

def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                     [0, 0, 0, 1]], np.float64)


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                     [0, 0, 0, 1]], np.float64)


def _rot_psi(psi):
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float64)


def perturb_rotation(c2w: np.ndarray, theta: float, phi: float,
                     psi: float = 0.0) -> np.ndarray:
    """Left-multiply world-frame eulers in degrees->rad (misc.py:594-603)."""
    hom = np.concatenate([c2w, [[0, 0, 0, 1]]], 0)
    hom = _rot_phi(phi / 180.0 * np.pi) @ hom
    hom = _rot_theta(theta / 180.0 * np.pi) @ hom
    hom = _rot_psi(psi / 180.0 * np.pi) @ hom
    return hom[:3, :4]


def perturb_single_render_pose(pose: np.ndarray, x: float, angle: float,
                               rng: np.random.Generator | None = None
                               ) -> np.ndarray:
    """Uniform rotation+translation jitter of one (3, 4) pose
    (misc.py:605-640). Returns (1, 3, 4)."""
    rng = rng or np.random.default_rng()
    out = np.array(pose, np.float64)
    loc = out[:, 3].copy()
    theta, phi, psi = rng.uniform(-angle, angle, 3)
    out = perturb_rotation(out, theta, phi, psi)
    out[:, 3] = loc + rng.uniform(-x, x, 3)
    return out[None].astype(np.float32)


def perturb_single_render_pose_norm(pose: np.ndarray, x: float,
                                    angle: float,
                                    rng: np.random.Generator | None = None
                                    ) -> np.ndarray:
    """L1-normalised-magnitude variant (misc.py:642-677)."""
    rng = rng or np.random.default_rng()
    out = np.array(pose, np.float64)
    t = rng.uniform(-x, x, 3)
    t = t / np.abs(t).sum() * x
    out[:, 3] = out[:, 3] + t
    r = rng.uniform(-angle, angle, 3)
    r = r / np.abs(r).sum() * angle
    out = perturb_rotation(out, *r)
    return out[None].astype(np.float32)


# ----------------------------------------------------------------------
# whole-set rendering + validation losses (misc.py:206-273, 678-765)
# ----------------------------------------------------------------------

@torch.no_grad()
def render_nerfw_imgs(model, poses, hists, hwf, near, far, cfg):
    """Render every pose of a set at full res (the render_nerfw_imgs role,
    misc.py:206-273) through render/validation.py's whole-image render
    (cfg's kernels; the field packed once) — returns (N, H, W, 3)
    numpy."""
    from nefes_tpu_torch.render.validation import (
        _device, _render_one_full, _tensor, _view_fns,
    )
    dev = _device(model)
    fns = model.field_fns(cfg)
    out = []
    for i in range(len(poses)):
        hist = _tensor(hists[i], dev)
        r = _render_one_full(model, _view_fns(model, fns, hist),
                             _tensor(poses[i], dev), hist, hwf, near, far,
                             cfg)
        out.append(r["rgb"].float().cpu().numpy())
    return np.stack(out)


def get_validation_loss(rendered, gt_images, gt_feats=None,
                        rendered_feats=None,
                        option_list=("pose",)) -> dict:
    """Multi-option val metrics (misc.py:678-765): photometric MSE
    ('pose' monitors the render), feature MSE / triplet / cosine."""
    from nefes_tpu_torch.refine.losses import feature_cosine_loss

    def tensor(x):
        return (x.float() if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x, np.float32)))
    out = {}
    if "pose" in option_list:
        out["pose"] = float(torch.mean(
            (tensor(rendered) - tensor(gt_images)) ** 2))
    if gt_feats is not None and rendered_feats is not None:
        rf, gf = tensor(rendered_feats), tensor(gt_feats)
        if "feature_mse" in option_list:
            out["feature_mse"] = float(torch.mean((rf - gf) ** 2))
        if "feature_triplet" in option_list:
            out["feature_triplet"] = float(
                triplet_loss_hard_negative_mining_plus(gf, rf))
        if "feature_cosine_similarity" in option_list:
            out["feature_cos"] = float(np.mean(
                [float(feature_cosine_loss(rf[i], gf[i]))
                 for i in range(rf.shape[0])]))
    return out
