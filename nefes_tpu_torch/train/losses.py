"""Training losses and the image metrics of refinement; port of
nefes_tpu/train/losses.py (reference script/models/losses.py).

The production NeFeS loss is NeRF-W's colour terms plus an L1 feature
term and an L1 fusion term, with the 0.02 / 0.04 stage weights applied as
in run_nefes.py:238-248: ``nefes_training_loss``.
"""

from __future__ import annotations

import torch

LAMBDA_U = 0.01  # NerfWLoss lambda_u (losses.py:104)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-10·log10(MSE) (reference img2mse / mse2psnr)."""
    return -10.0 * torch.log10(mse(pred, target))


def nerfw_loss(rgb_coarse: torch.Tensor, rgb_fine: torch.Tensor,
               target: torch.Tensor, beta: torch.Tensor | None = None,
               transient_sigmas: torch.Tensor | None = None,
               lambda_u: float = LAMBDA_U) -> torch.Tensor:
    """NeRF-W Eq. 13 (reference losses.py:89-132): 0.5·coarse MSE +
    beta-weighted fine MSE + log-beta (+3) + transient-sigma regulariser;
    without beta, 0.5·fine MSE."""
    loss = 0.5 * mse(rgb_coarse, target)
    if beta is None:
        return loss + 0.5 * mse(rgb_fine, target)
    loss = loss + torch.mean((rgb_fine - target) ** 2
                             / (2.0 * beta[..., None] ** 2))
    loss = loss + 3.0 + torch.mean(torch.log(beta))
    return loss + lambda_u * torch.mean(transient_sigmas)


def color_loss(rgb_coarse, rgb_fine, target) -> torch.Tensor:
    """Plain MSE fine + coarse (losses.py:4-15)."""
    return mse(rgb_fine, target) + mse(rgb_coarse, target)


def masked_l1(a: torch.Tensor, b: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean |a - b| over pixels with mask > 0; mask broadcasts against the
    leading dims of a ((B, N) weights against (B, N, C) features)."""
    m = (mask > 0).to(a.dtype)[..., None]
    denom = torch.clamp_min(m.sum() * a.shape[-1], 1.0)
    return (torch.abs(a - b) * m).sum() / denom


def nefes_training_loss(outputs: dict, target_rgb: torch.Tensor,
                        target_feat: torch.Tensor | None,
                        fusion_out: torch.Tensor | None, stage: int,
                        feat_weight: float = 0.04,
                        fusion_weight: float = 0.02,
                        mask: torch.Tensor | None = None):
    """The staged production loss; returns (loss, metrics dict).

    stage 0: colour only (NeRF-W colour terms, run_nefes.py:249-251)
    stage 1: + feat_weight·L1(feat, target_feat)       (:244-248, 0.04)
    stage 2: + fusion_weight·(L1 feat + L1 fusion)     (:238-243, 0.02)

    outputs: the train render dict with outputs["rgb"] after the exposure
    transform. mask: optional (B, N) validity weights on the feature and
    fusion terms (the stage-2 patches cannot leave masked pixels out)."""
    # with the transient heads off the compositor returns a zero beta map:
    # the Eq. 13 beta terms fall back to plain MSE, or log(beta) explodes
    ts = outputs.get("transient_sigmas")
    loss_rgb = nerfw_loss(outputs["rgb0"], outputs["rgb"], target_rgb,
                          beta=outputs.get("beta") if ts is not None
                          else None,
                          transient_sigmas=ts)
    metrics = {"loss_rgb": loss_rgb}
    if stage == 0:
        return loss_rgb, metrics

    def feat_l1(a, b):
        return l1(a, b) if mask is None else masked_l1(a, b, mask)

    loss_f = feat_l1(outputs["feat"], target_feat)
    metrics["loss_feat"] = loss_f
    if stage == 1:
        return loss_rgb + feat_weight * loss_f, metrics
    loss_fusion = feat_l1(fusion_out, target_feat)
    metrics["loss_fusion"] = loss_fusion
    return (loss_rgb + fusion_weight * loss_f + fusion_weight * loss_fusion,
            metrics)
