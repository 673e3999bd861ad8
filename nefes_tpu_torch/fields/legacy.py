"""The legacy fields of the flag-selectable zoo; port of
nefes_tpu/fields/legacy.py.

  PlainNeRF  the original NeRF MLP (reference script/models/nerf.py: D=8,
             W=256, skip at 4, ReLU sigma, view-dependent sigmoid rgb)
  NeRFW      NeRF-Hist without the feature head (reference
             script/models/nerfh.py:369-520): softplus sigma, the fine
             tower's appearance-conditioned colour and transient heads

Both return the renderer's head dict with a zero-width static_feat, so
the compositor takes them as it takes NeRFH-NFF. Layers carry the flax
names; a skip layer is one Linear over [input, hidden].
"""

from __future__ import annotations

import torch
from torch import nn

from nefes_tpu_torch.fields.hashgrid import _with_latent
from nefes_tpu_torch.fields.nerfh_nff import _dense, softplus


def _trunk(mod: nn.Module, prefix: str, x: torch.Tensor,
           dt: torch.dtype) -> torch.Tensor:
    """The depth-layer ReLU trunk, the input concatenated in front of the
    hidden state at each skip."""
    h = x
    for i in range(mod.depth):
        if i in mod.skips:
            h = torch.cat([x, h], dim=-1)
        h = torch.relu(_dense(getattr(mod, f"{prefix}{i + 1}"), h, dt))
    return h


def _add_trunk(mod: nn.Module, prefix: str, in_xyz: int) -> None:
    for i in range(mod.depth):
        n_in = (in_xyz if i == 0 else mod.width) \
            + (in_xyz if i in mod.skips else 0)
        mod.add_module(f"{prefix}{i + 1}", nn.Linear(n_in, mod.width))


class PlainNeRF(nn.Module):
    """The original NeRF MLP (reference nerf.py)."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: tuple[int, ...] = (4,), in_channels_xyz: int = 63,
                 in_channels_dir: int = 27,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.dtype = dtype
        _add_trunk(self, "layer_", in_channels_xyz)
        self.sigma = nn.Linear(width, 1)
        self.feature = nn.Linear(width, width)
        self.dir_branch = nn.Linear(width + in_channels_dir, width // 2)
        self.rgb = nn.Linear(width // 2, 3)

    def forward(self, xyz_emb: torch.Tensor,
                dir_emb: torch.Tensor | None = None,
                sigma_only: bool = False,
                output_transient: bool = False) -> dict:
        dt = self.dtype
        h = _trunk(self, "layer_", xyz_emb.to(dt), dt)
        sigma = torch.relu(_dense(self.sigma, h, dt))[..., 0]
        out = {"static_sigma": sigma.float()}
        if sigma_only:
            return out
        feat = _dense(self.feature, h, dt)
        d = torch.relu(_dense(self.dir_branch,
                              torch.cat([feat, dir_emb.to(dt)], dim=-1), dt))
        rgb = torch.sigmoid(_dense(self.rgb, d, dt))
        out["static_rgb"] = rgb.float()
        # a zero-width feature head keeps the compositor's interface
        out["static_feat"] = rgb.new_zeros(rgb.shape[:-1] + (0,)).float()
        return out


class NeRFW(nn.Module):
    """The NeRF-W / NeRF-Hist tower without the 128-D feature head
    (reference nerfh.py:369-520). a_latent / t_latent are the appearance
    and transient latents (..., in_channels_a / in_channels_t), taken by
    the fine tower only; the coarse one has no transient heads."""

    def __init__(self, typ: str = "coarse", depth: int = 8,
                 width: int = 128, skips: tuple[int, ...] = (4,),
                 in_channels_xyz: int = 63, in_channels_dir: int = 27,
                 in_channels_a: int = 50, in_channels_t: int = 20,
                 beta_min: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.typ, self.depth, self.width = typ, depth, width
        self.skips, self.dtype = tuple(skips), dtype
        fine = typ == "fine"
        W, Ed, Hd = width, in_channels_dir, width // 2
        _add_trunk(self, "xyz_encoding_", in_channels_xyz)
        self.static_sigma = nn.Linear(W, 1)
        self.xyz_encoding_final = nn.Linear(W, W)
        self.dir_encoding = nn.Linear(
            W + Ed + (in_channels_a if fine else 0), Hd)
        self.static_rgb = nn.Linear(Hd, 3)
        if fine:
            self.transient_encoding_1 = nn.Linear(W + Ed + in_channels_t, Hd)
            self.transient_encoding_2 = nn.Linear(Hd, Hd)
            self.transient_encoding_3 = nn.Linear(Hd, Hd)
            self.transient_sigma = nn.Linear(Hd, 1)
            self.transient_rgb = nn.Linear(Hd, 3)
            self.transient_beta = nn.Linear(Hd, 1)

    def forward(self, xyz_emb: torch.Tensor,
                dir_emb: torch.Tensor | None = None,
                a_latent: torch.Tensor | None = None,
                t_latent: torch.Tensor | None = None,
                sigma_only: bool = False,
                output_transient: bool = True) -> dict:
        dt = self.dtype
        fine = self.typ == "fine"
        h = _trunk(self, "xyz_encoding_", xyz_emb.to(dt), dt)
        sigma = softplus(_dense(self.static_sigma, h, dt))[..., 0]
        out = {"static_sigma": sigma.float()}
        if sigma_only:
            return out
        final = _dense(self.xyz_encoding_final, h, dt)
        d = _with_latent([final, dir_emb], a_latent if fine else None, dt)
        d = torch.relu(_dense(self.dir_encoding, d, dt))
        out["static_rgb"] = torch.sigmoid(
            _dense(self.static_rgb, d, dt)).float()
        out["static_feat"] = d.new_zeros(d.shape[:-1] + (0,)).float()
        if not (fine and output_transient):
            return out
        t = _with_latent([final, dir_emb], t_latent, dt)
        for i in range(3):
            t = torch.relu(_dense(
                getattr(self, f"transient_encoding_{i + 1}"), t, dt))
        out["transient_sigma"] = softplus(
            _dense(self.transient_sigma, t, dt))[..., 0].float()
        out["transient_rgb"] = torch.sigmoid(
            _dense(self.transient_rgb, t, dt)).float()
        out["transient_beta"] = softplus(
            _dense(self.transient_beta, t, dt))[..., 0].float()
        return out
