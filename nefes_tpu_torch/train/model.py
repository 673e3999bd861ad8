"""NeFeSModel: the model bundle (coarse field, fine field, exposure MLP,
FusionNet) as one nn.Module; port of nefes_tpu/train/model.py.

Field fns are closures over their weights: ``fn(xyz_emb, dir_emb,
sigma_only, output_transient)`` -> head dict, the JAX package's field fns
minus their params slot. The ``*_pre_fn`` builders return the same
signature over the pre-embedded kernels (kernels/), the ``*_raw_fn``
builders ``fn(pts, dirs, sigma_only, output_transient)`` over the
raw-input kernels; both are bound to weights packed with ``pack_fused``,
once per refinement (frozen, under torch.no_grad()) or once per training
step (with autograd, for need_dw=True). ``field_fns`` picks the pair a
RenderConfig asks for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.fields.nerfh_nff import (
    FEATURE_DIM, ExposureMLP, FusionNet, NeRFHNFF, affine_color_transform,
)
from nefes_tpu_torch.kernels.fused_field import (
    FieldSpec, fused_field_apply, fused_field_apply_pre, pack_params,
)
from nefes_tpu_torch.kernels.fused_render import (
    fused_render_apply, fused_render_apply_pre,
)
from nefes_tpu_torch.render.renderer import RenderConfig

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@dataclass(frozen=True)
class ModelConfig:
    depth: int = 8
    width: int = 128
    feature_dim: int = FEATURE_DIM
    skips: tuple[int, ...] = (4,)
    hist_bin: int = 10
    encode_hist: bool = True
    fusion_residual: bool = False
    fusion_no_bn: bool = False
    xyz_embed: EmbedConfig = EmbedConfig(num_freqs=10)
    dir_embed: EmbedConfig = EmbedConfig(num_freqs=4)
    dtype: torch.dtype = torch.float32

    @property
    def dtype_name(self) -> str:
        return _NAMES[self.dtype]

    def render_config(self, **overrides) -> RenderConfig:
        overrides.setdefault("embed_dtype", self.dtype_name)
        return RenderConfig(xyz_embed=self.xyz_embed,
                            dir_embed=self.dir_embed, **overrides)

    @classmethod
    def tiny(cls) -> "ModelConfig":
        """Small config for CPU tests."""
        return cls(depth=2, width=32, feature_dim=8, skips=(1,),
                   xyz_embed=EmbedConfig(num_freqs=4),
                   dir_embed=EmbedConfig(num_freqs=2))


class NeFeSModel(nn.Module):
    """Coarse + fine NeRFH-NFF, exposure MLP and FusionNet. Parameters are
    f32; the forward computes in cfg.dtype. Weights start random (PyTorch's
    default init, from the global or a given generator's seed); load
    trained ones with weights.from_jax_variables."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(depth=c.depth, width=c.width, skips=c.skips,
                  in_channels_xyz=c.xyz_embed.out_dim,
                  in_channels_dir=c.dir_embed.out_dim,
                  feature_dim=c.feature_dim, dtype=c.dtype,
                  head_dtype=c.dtype)
        self.coarse = NeRFHNFF(typ="coarse", **kw)
        self.fine = NeRFHNFF(typ="fine", **kw)
        self.exposure = ExposureMLP(hist_bin=c.hist_bin, dtype=c.dtype)
        self.fusion = FusionNet(feature_dim=c.feature_dim,
                                residual=c.fusion_residual,
                                no_bn=c.fusion_no_bn, dtype=c.dtype)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw every weight and bias from `generator` (uniform with the
        fan-in bound of PyTorch's default init), so a seed fixes the model
        whatever device it is built for."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = mod.weight[0].numel() ** -0.5
                for t in (mod.weight, mod.bias):
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)

    # --- unfused field fns (plain PyTorch) ---

    def coarse_fn(self, xyz_emb, dir_emb=None, sigma_only=False,
                  output_transient=False):
        return self.coarse(xyz_emb, dir_emb, sigma_only, output_transient)

    def fine_fn(self, xyz_emb, dir_emb=None, sigma_only=False,
                output_transient=True):
        return self.fine(xyz_emb, dir_emb, sigma_only, output_transient)

    # --- kernel paths (kernels/) ---

    def fused_spec(self, typ: str) -> FieldSpec:
        return FieldSpec.from_model(self.cfg, typ, dtype=self.cfg.dtype_name)

    def pack_fused(self) -> tuple:
        """(packed_coarse, packed_fine): the weights in the kernels' one
        layout, read by the pre-embedded and the raw-input kernels, built
        with autograd from the parameters. A refinement packs once, under
        torch.no_grad(); a training step packs anew, so that the kernels'
        weight gradients (need_dw=True) reach the parameters."""
        return (pack_params(self.coarse, self.fused_spec("coarse")),
                pack_params(self.fine, self.fused_spec("fine")))

    def _field_fn(self, apply, typ: str, packed, need_dw: bool):
        spec = self.fused_spec(typ)

        def fn(x, dirs=None, sigma_only=False, output_transient=True):
            return apply(spec, packed, x, dirs, sigma_only=sigma_only,
                         output_transient=output_transient, need_dw=need_dw)
        return fn

    def _render_fn(self, apply, packed):
        spec = self.fused_spec("fine")
        return lambda x, dirs, z: apply(spec, packed, x, dirs, z)

    def coarse_pre_fn(self, packed, need_dw: bool = False):
        """(xyz_emb (..., E), dir_emb (..., Ed) | None, sigma_only,
        output_transient) -> head dict through the pre-embedded kernels."""
        return self._field_fn(fused_field_apply_pre, "coarse", packed,
                              need_dw)

    def fine_pre_fn(self, packed, need_dw: bool = False):
        return self._field_fn(fused_field_apply_pre, "fine", packed, need_dw)

    def fine_render_pre_fn(self, packed):
        """(xyz_emb (R,S,E), dir_emb (R,S,Ed), z (R,S)) -> per-ray dict
        through the composite-fused render kernels."""
        return self._render_fn(fused_render_apply_pre, packed)

    def coarse_raw_fn(self, packed, need_dw: bool = False):
        """(pts (..., 3), dirs (..., 3) | None, sigma_only,
        output_transient) -> head dict through the raw-input kernels."""
        return self._field_fn(fused_field_apply, "coarse", packed, need_dw)

    def fine_raw_fn(self, packed, need_dw: bool = False):
        return self._field_fn(fused_field_apply, "fine", packed, need_dw)

    def fine_render_raw_fn(self, packed):
        """(pts (R,S,3), viewdirs (R,3), z (R,S)) -> per-ray dict through
        the raw-input composite-fused render kernels."""
        return self._render_fn(fused_render_apply, packed)

    def ray_field_fns(self, hist=None):
        """(coarse_fn, fine_fn) for one image. The NFF field has no
        per-image latent, so the bound methods, whatever the histogram
        (the JAX package's field zoo binds per-image latents here)."""
        return self.coarse_fn, self.fine_fn

    def field_fns(self, cfg: RenderConfig, packed=None):
        """(coarse_fn, fine_fn) for render_rays under cfg: the plain
        fields or, with cfg.fused, the kernel fns bound to `packed`
        (pack_fused(); packed here when None), pre-embedded (cfg.fused_pre)
        or raw-input, with need_dw=cfg.fused_need_dw, the fine one
        composite-fused with cfg.fused_render."""
        if not cfg.fused:
            return self.ray_field_fns()
        packed_c, packed_f = packed if packed is not None \
            else self.pack_fused()
        dw = cfg.fused_need_dw
        if cfg.fused_pre:
            return (self.coarse_pre_fn(packed_c, need_dw=dw),
                    self.fine_render_pre_fn(packed_f) if cfg.fused_render
                    else self.fine_pre_fn(packed_f, need_dw=dw))
        return (self.coarse_raw_fn(packed_c, need_dw=dw),
                self.fine_render_raw_fn(packed_f) if cfg.fused_render
                else self.fine_raw_fn(packed_f, need_dw=dw))

    # --- exposure and fusion ---

    def apply_exposure(self, hist: torch.Tensor,
                       rgb: torch.Tensor) -> torch.Tensor:
        """hist (B, bins), rgb (B, N, 3) raw -> exposure-corrected sigmoid
        rgb; with encode_hist off, only the sigmoid."""
        if not self.cfg.encode_hist:
            return torch.sigmoid(rgb)
        return affine_color_transform(self.exposure(hist), rgb)

    def apply_fusion(self, rgb_img: torch.Tensor, feat_img: torch.Tensor,
                     bn_stats: str = "batch", train: bool = False):
        """rgb_img (B, H, W, 3), feat_img (B, H, W, F) -> fused features
        (B, H, W, F) f32. At inference (train=False), bn_stats "batch"
        normalises with this input's statistics and leaves the running
        ones untouched (the reference's operating point: its BN is never
        put in eval mode); "running" uses the running averages.
        train=True (the stage-2 step) normalises with batch statistics and
        returns (out, new running stats | None) for the step to apply, as
        the JAX package's apply_fusion(train=True) does."""
        if bn_stats not in ("batch", "running"):
            raise ValueError(f"bn_stats {bn_stats!r}")
        x = torch.cat([rgb_img, feat_img.to(rgb_img.dtype)], dim=-1)
        if train:
            return self.fusion(x, train=True)
        return self.fusion(x, use_batch_stats=bn_stats == "batch")
