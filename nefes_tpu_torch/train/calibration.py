"""Closed-form fit of FusionNet's trailing-BN affine; port of
nefes_tpu/train/calibration.py.

With the conv stack frozen, the L2 fusion loss is quadratic in the BN's
(scale, bias), so its stationary point, where SGD is heading, has a
closed form: the per-channel least-squares affine from the conv stack's
output to the DFNet targets. A short stage 2 leaves that affine far from
its optimum (the reference's schedule gives it ~10x longer: EPOCH_TO_FUSION
= 200 of ~2,000 epochs, script/run_nefes.py:34-40); this module sets it
there directly. The running statistics it writes are what refinement's
--fusion_bn running reads. Converted reference checkpoints never need it.
"""

from __future__ import annotations

import torch

from nefes_tpu_torch.fields.nerfh_nff import FusionNet


@torch.no_grad()
def fusion_pre_bn(model, rgb_imgs: torch.Tensor,
                  raw_feats: torch.Tensor) -> torch.Tensor:
    """FusionNet's conv-stack output before the trailing BN, f32.

    rgb_imgs (N, h, w, 3) exposure-corrected renders, raw_feats
    (N, h, w, F) rendered features: the inference inputs."""
    src = model.fusion
    fnet = FusionNet(feature_dim=model.cfg.feature_dim, no_bn=True,
                     dtype=torch.float32).to(src.conv0.weight.device)
    fnet.load_state_dict({k: v for k, v in src.state_dict().items()
                          if k.startswith("conv")})
    x = torch.cat([rgb_imgs.float(), raw_feats.float()], dim=-1)
    return fnet(x)


@torch.no_grad()
def calibrate_fusion_bn(model, rgb_imgs: torch.Tensor,
                        raw_feats: torch.Tensor, targets: torch.Tensor,
                        eps: float = 1e-5) -> dict:
    """Fit the per-channel least-squares affine pre_bn -> target on the
    given (train-split) views and write it into model.fusion.bn, in place.

    Both normalisation modes then realise the fitted affine: the running
    statistics become the calibration population's mean and (biased)
    variance, so bn_stats="running" applies it exactly, and scale and
    bias are chosen so that under batch statistics close to that
    population (bn_stats="batch", the reference's operating point) the
    output matches it too: BN(x) = g·(x-μ)/sqrt(σ²+ε) + b ≡ a·x + c with
    g = a·sqrt(σ²+ε), b = c + a·μ.

    Returns the fit's quality: the per-channel correlation's median and
    share above |0.5|, the L1 after the fit on the calibration views, the
    scale's median and the bias's range."""
    if model.fusion.no_bn:
        raise ValueError("calibration fits the trailing BN's affine; this "
                         "FusionNet has no BN (no_fusion_BN)")
    pre = fusion_pre_bn(model, rgb_imgs, raw_feats)
    C = pre.shape[-1]
    F = pre.reshape(-1, C)
    T = targets.float().reshape(-1, C)
    mu_f, mu_t = F.mean(0), T.mean(0)
    var_f = F.var(0, unbiased=False)
    cov = ((F - mu_f) * (T - mu_t)).mean(0)
    a = cov / (var_f + eps)
    c = mu_t - a * mu_f
    scale = a * torch.sqrt(var_f + eps)
    bias = c + a * mu_f

    bn = model.fusion.bn
    bn.weight.copy_(scale)
    bn.bias.copy_(bias)
    bn.running_mean.copy_(mu_f)
    bn.running_var.copy_(var_f)

    corr = cov / torch.sqrt((var_f + eps) * (T.var(0, unbiased=False) + eps))
    return {
        "corr_median": float(torch.quantile(corr, 0.5)),
        "corr_frac_gt_0p5": float(torch.mean((corr.abs() > 0.5).float())),
        "l1_post": float(torch.mean(torch.abs(F * a + c - T))),
        "scale_median": float(torch.quantile(scale, 0.5)),
        "bias_range": [float(bias.min()), float(bias.max())],
    }
