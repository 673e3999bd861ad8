"""The differentiable volume renderer; port of
nefes_tpu/render/renderer.py (reference script/models/rendering.py:68-243).

Field functions are closures over their weights, called as
``fn(xyz_emb, dir_emb, sigma_only, output_transient)`` -> head dict: the
flax field fns of the JAX package minus their params slot. With
``cfg.fused and cfg.fused_pre`` the same embed branch drives the
pre-embedded kernel fns (NeFeSModel.coarse_pre_fn / fine_pre_fn), and
with ``cfg.fused_render`` the fine pass and its composite are one kernel
(NeFeSModel.fine_render_pre_fn: ``fn(xyz_emb, dir_emb, z)`` -> per-ray
dict). With ``cfg.fused`` and not ``cfg.fused_pre`` nothing is embedded
here: the raw-input kernel fns take the points and directions
(NeFeSModel.coarse_raw_fn / fine_raw_fn: ``fn(pts, dirs, sigma_only,
output_transient)``; fine_render_raw_fn: ``fn(pts, viewdirs, z)``).

``window`` is the Nerfies coarse-to-fine pair (xyz_window, dir_window) of
reduce_embedding=2 (fields/embedder.py:train_windows), applied where the
points and directions are embedded here. The raw-input kernels embed
inside the kernel and cannot apply it: a window on that path raises (the
JAX package's raw path drops it, ROADMAP Queue C).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from nefes_tpu_torch.fields.embedder import EmbedConfig, embed
from nefes_tpu_torch.geometry.rays import get_rays
from nefes_tpu_torch.render.compositor import composite
from nefes_tpu_torch.render.sampling import (
    hierarchical_samples, stratified_samples,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering options (the reference's render_kwargs); the same
    fields and defaults as the JAX package's RenderConfig."""

    n_samples: int = 64
    n_importance: int = 64
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    beta_min: float = 0.1
    use_fine_only: bool = False
    test_time: bool = False
    transient_at_test: bool = False
    output_transient: bool = True
    xyz_embed: EmbedConfig = EmbedConfig(num_freqs=10)
    dir_embed: EmbedConfig = EmbedConfig(num_freqs=4)
    # kernel path (kernels/): fused=True runs the field through the Hopper
    # kernels, on embeddings made here (fused_pre=True) or on raw points
    # and directions that the kernels embed (fused_pre=False).
    # fused_need_dw=True gives the weights their gradients through the
    # kernels (training); False is the frozen field (refinement).
    fused: bool = False
    fused_need_dw: bool = True
    fused_pre: bool = False
    # dtype the frequency embeddings are materialised in
    embed_dtype: str = "float32"
    # fine pass and composite in one kernel (frozen-field test-time path)
    fused_render: bool = False
    # recompute field activations in the backward of the unfused path
    remat: bool = True

    def test(self) -> "RenderConfig":
        """The render_kwargs_test variant."""
        return replace(self, perturb=False, raw_noise_std=0.0,
                       test_time=True, remat=False)


FieldFn = Callable[..., dict]


def _query(field_fn: FieldFn, pts: torch.Tensor, viewdirs: torch.Tensor,
           cfg: RenderConfig, sigma_only: bool, output_transient: bool,
           window=None) -> dict:
    """Embed sample points (and directions) over the (R, S) grid, under
    the window when given, and apply the field; the raw-input kernel fns
    (fused, not fused_pre) embed themselves and take the points and
    directions."""
    if cfg.fused and not cfg.fused_pre:
        dirs = None if sigma_only else viewdirs[..., None, :].expand(
            pts.shape)
        return field_fn(pts, dirs, sigma_only, output_transient)
    w_xyz, w_dir = window if window is not None else (None, None)
    ed = _DTYPES[cfg.embed_dtype]
    xyz_emb = embed(pts, cfg.xyz_embed, w_xyz).to(ed)
    if sigma_only:
        return field_fn(xyz_emb, None, True, False)
    dirs = viewdirs[..., None, :].expand(pts.shape)
    dir_emb = embed(dirs, cfg.dir_embed, w_dir).to(ed)
    return field_fn(xyz_emb, dir_emb, False, output_transient)


def render_rays(coarse_fn: FieldFn, fine_fn: FieldFn | None,
                rays_o: torch.Tensor, rays_d: torch.Tensor, near, far,
                rng: torch.Generator | None, cfg: RenderConfig,
                remat: bool = True, window=None) -> dict:
    """Render a batch of rays (R, 3). Returns rgb/feat/disp/acc/depth, plus
    the coarse outputs and the transient terms at train time. window:
    the Nerfies pair (xyz_window, dir_window) or None."""
    if window is not None and cfg.fused and not cfg.fused_pre:
        raise ValueError("the raw-input kernels embed inside the kernel "
                         "and cannot apply the Nerfies window: render a "
                         "window through fused_pre (K1/K2) or unfused")
    n_rays = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    z_vals = stratified_samples(rng, n_rays, cfg.n_samples, near, far,
                                lindisp=cfg.lindisp, perturb=cfg.perturb,
                                device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., None]

    query = _query
    if remat and cfg.remat and not cfg.fused:
        def query(*args):
            return checkpoint(_query, *args, use_reentrant=False)

    # coarse pass: sigma-only at test time; its weights only place the
    # fine samples, which are detached, so it needs no autograd graph
    coarse_sigma_only = cfg.test_time and cfg.n_importance > 0
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not coarse_sigma_only):
        raw_c = query(coarse_fn, pts, viewdirs, cfg, coarse_sigma_only,
                      False, window)
        out_c = composite(raw_c, z_vals, raw_noise_std=cfg.raw_noise_std,
                          noise_rng=rng, output_transient=False,
                          white_bkgd=cfg.white_bkgd, test_time=cfg.test_time,
                          sigma_only=coarse_sigma_only)
    if cfg.n_importance == 0:
        return {k: out_c[k] for k in ("rgb", "feat", "disp", "acc", "depth")}

    z_vals_f = hierarchical_samples(rng, z_vals, out_c["weights"],
                                    cfg.n_importance, det=not cfg.perturb,
                                    combine=not cfg.use_fine_only)
    pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_f[..., None]

    if cfg.fused and cfg.fused_render:
        if not (cfg.test_time and not cfg.output_transient):
            raise ValueError("fused_render covers the refinement render "
                             "only (test_time, no transient heads)")
        if cfg.fused_pre:
            w_xyz, w_dir = window if window is not None else (None, None)
            ed = _DTYPES[cfg.embed_dtype]
            xyz_emb = embed(pts_f, cfg.xyz_embed, w_xyz).to(ed)
            dirs_f = viewdirs[..., None, :].expand(pts_f.shape)
            dir_emb = embed(dirs_f, cfg.dir_embed, w_dir).to(ed)
            out_f = fine_fn(xyz_emb, dir_emb, z_vals_f)
        else:
            out_f = fine_fn(pts_f, viewdirs, z_vals_f)
        return {k: out_f[k] for k in ("rgb", "feat", "disp", "acc", "depth")}

    raw_f = query(fine_fn, pts_f, viewdirs, cfg, False, cfg.output_transient,
                  window)
    out_f = composite(raw_f, z_vals_f, raw_noise_std=cfg.raw_noise_std,
                      noise_rng=rng, output_transient=cfg.output_transient,
                      beta_min=cfg.beta_min, white_bkgd=cfg.white_bkgd,
                      test_time=cfg.test_time,
                      transient_at_test=cfg.transient_at_test)
    ret = {k: out_f[k] for k in ("rgb", "feat", "disp", "acc", "depth")}
    if not cfg.test_time:
        ret.update({
            "rgb0": out_c["rgb"], "feat0": out_c["feat"],
            "disp0": out_c["disp"], "acc0": out_c["acc"],
            "beta": out_f["beta"],
            "transient_sigmas": out_f["transient_sigmas"],
            "static_sigmas": raw_f["static_sigma"],
        })
    return ret


_IMAGE_KEYS = ("rgb", "feat", "disp", "acc", "depth",
               "rgb0", "feat0", "disp0", "acc0")


def render_image(coarse_fn: FieldFn, fine_fn: FieldFn | None, H: int,
                 W: int, focal: float, c2w: torch.Tensor, near: float,
                 far: float, cfg: RenderConfig,
                 rng: torch.Generator | None = None,
                 block_rays: int = 0, window=None) -> dict:
    """Render an H×W image from a (3, 4) pose. block_rays > 0 renders in
    blocks of that many rays to bound peak memory; 0 renders all rays at
    once. window as render_rays'."""
    rays_o, rays_d = get_rays(H, W, focal, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = rays_o.shape[0]
    if block_rays and n > block_rays:
        parts = [render_rays(coarse_fn, fine_fn, rays_o[i:i + block_rays],
                             rays_d[i:i + block_rays], near, far, rng, cfg,
                             window=window)
                 for i in range(0, n, block_rays)]
        out = {k: (torch.cat([p[k] for p in parts])
                   if parts[0][k] is not None else None) for k in parts[0]}
    else:
        out = render_rays(coarse_fn, fine_fn, rays_o, rays_d, near, far, rng,
                          cfg, window=window)
    return {k: (v.reshape(H, W, *v.shape[1:])
                if k in _IMAGE_KEYS and v is not None else v)
            for k, v in out.items()}
