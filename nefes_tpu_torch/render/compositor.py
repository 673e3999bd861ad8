"""NeRF-W volume compositing with the NeFeS feature head; port of
nefes_tpu/render/compositor.py (reference raw2outputs_NeRFH_NFF,
script/models/nerfh_nff.py:25-166). Kept exactly:

  * deltas with a 1e2 tail, no direction-norm scaling;
  * the transient path's joint transmittance, beta_min after composition;
  * feature maps composited with stop-gradient weights;
  * the test-time static-only path;
  * transmittance below 1e-24 flushed to exact zero.
"""

from __future__ import annotations

import torch

from nefes_tpu_torch.render.sampling import draw

DELTA_INF = 1e2


def _contract(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_s w[..., s] * x[..., s, c] -> (..., C) with f32 accumulation,
    the weights rounded to x's dtype first as the JAX einsum does."""
    return torch.einsum("...s,...sc->...c", w.to(x.dtype).float(), x.float())


def _weights(alphas: torch.Tensor):
    """alphas (R, S) -> (alpha_i * prod_{j<i}(1 - alpha_j), transmittance)."""
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas[..., :-1]], dim=-1)
    trans = torch.cumprod(shifted, dim=-1)
    trans = torch.where(trans > 1e-24, trans, torch.zeros_like(trans))
    return alphas * trans, trans


def composite(raw: dict, z_vals: torch.Tensor, raw_noise_std: float = 0.0,
              noise_rng: torch.Generator | None = None,
              output_transient: bool = False, beta_min: float = 0.1,
              white_bkgd: bool = False, test_time: bool = False,
              transient_at_test: bool = False,
              sigma_only: bool = False) -> dict:
    """Composite per-sample heads (R, S) / (R, S, C) along each ray.
    Returns rgb, feat, disp, acc, weights, depth, transient_sigmas, beta
    (None where not computed on that path)."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], DELTA_INF)],
                       dim=-1)
    static_sigmas = raw["static_sigma"].float()

    if sigma_only:
        weights, _ = _weights(1.0 - torch.exp(-deltas * static_sigmas))
        return {"weights": weights, "acc": weights.sum(-1), "rgb": None,
                "feat": None, "disp": None, "depth": None,
                "transient_sigmas": None, "beta": None}

    static_rgbs, static_feats = raw["static_rgb"], raw["static_feat"]
    if output_transient:
        transient_sigmas = raw["transient_sigma"].float()
        static_alphas = 1.0 - torch.exp(-deltas * static_sigmas)
        transient_alphas = 1.0 - torch.exp(-deltas * transient_sigmas)
        alphas = 1.0 - torch.exp(-deltas * (static_sigmas + transient_sigmas))
    else:
        noise = 0.0
        if raw_noise_std > 0.0 and noise_rng is not None:
            noise = draw(noise_rng, static_sigmas.shape,
                         static_sigmas.device, normal=True) * raw_noise_std
        alphas = 1.0 - torch.exp(-deltas * (static_sigmas + noise))
        transient_sigmas = None

    weights, trans = _weights(alphas)
    acc = weights.sum(-1)

    if output_transient:
        static_weights = static_alphas * trans
        transient_weights = transient_alphas * trans
        if test_time and not transient_at_test:
            s_weights, _ = _weights(static_alphas)
            rgb = _contract(s_weights, static_rgbs)
            feat = _contract(s_weights.detach(), static_feats)
            depth = (s_weights * z_vals).sum(-1)
            disp = 1.0 / torch.clamp_min(depth / s_weights.sum(-1), 1e-10)
            return {"rgb": rgb, "feat": feat, "disp": disp, "acc": acc,
                    "weights": s_weights, "depth": depth,
                    "transient_sigmas": transient_sigmas,
                    "beta": torch.zeros_like(acc)}
        static_rgb_map = _contract(static_weights, static_rgbs)
        feat = _contract(static_weights.detach(), static_feats)
        if white_bkgd:
            static_rgb_map = static_rgb_map + (1.0 - acc[..., None])
        transient_rgb_map = _contract(transient_weights, raw["transient_rgb"])
        beta = (transient_weights
                * raw["transient_beta"].float()).sum(-1) + beta_min
        rgb = static_rgb_map + transient_rgb_map
    else:
        rgb = _contract(weights, static_rgbs)
        feat = _contract(weights.detach(), static_feats)
        beta = torch.zeros_like(acc)

    depth = (weights * z_vals).sum(-1)
    disp = 1.0 / torch.clamp_min(depth / weights.sum(-1), 1e-10)
    return {"rgb": rgb, "feat": feat, "disp": disp, "acc": acc,
            "weights": weights, "depth": depth,
            "transient_sigmas": transient_sigmas, "beta": beta}
