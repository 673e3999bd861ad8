"""The instant-ngp hash-grid field, the tcnn variant (``--tcnn``); port of
nefes_tpu/fields/hashgrid.py (reference script/models/nerfh_tcnn.py:55-175:
tcnn HashGrid L=16, F=2, T=2^19, base 16 -> 2048; sigma net 1x64 -> 1+15;
SH degree-4 direction encoding; colour net 2x64; transient net 3x64; the
[-bound, bound] -> [0, 1] input map at :151-156) and the multiresolution
hash encoding of Müller et al. 2022 (Eq. 3-4).

Each level gathers its 8 corner rows at once (index_select, whose
gradient is a scatter-add into the table) and blends them trilinearly.
The spatial hash is instant-ngp's, in uint32 arithmetic with wraparound:
here in int64, each product masked to 32 bits before the xor and the
modulo. The base cell is clamped so that every corner row lies in its
table (the JAX package's clamps; an out-of-range row would be NaN there
and a device-side assert on the card). Levels coarse enough to fit
densely index the table directly, so converted tcnn checkpoints line up.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nefes_tpu_torch.fields.nerfh_nff import _dense

# instant-ngp's spatial-hash primes (Eq. 4)
_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
# the corners of a cell, (8, 3): corner c has offsets (c>>2 & 1, c>>1 & 1,
# c & 1) along x, y, z
_CORNERS = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)])


def spherical_harmonics_deg4(d: torch.Tensor) -> torch.Tensor:
    """The real SH basis to degree 4 (16 coefficients) of unit directions
    (..., 3), in tcnn's / instant-ngp's order (it replaces tcnn's
    SphericalHarmonics encoding, nerfh_tcnn.py:97-103)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


def level_layout(n_levels: int, log2_table_size: int, base_resolution: int,
                 max_resolution: int, tcnn_exact: bool) -> tuple:
    """(resolutions, scales, table rows) of each level. tcnn_exact: the
    scale b^l·base - 1, resolution ceil(scale) + 1 and rows 8-aligned;
    otherwise resolution floor(base·b^l) and a dense table of
    (res + 1)³ rows when that fits in 2^log2_table_size."""
    L, T = n_levels, 2 ** log2_table_size
    growth = np.exp(np.log(max_resolution / base_resolution) / (L - 1))
    if tcnn_exact:
        scales = [growth ** l * base_resolution - 1.0 for l in range(L)]
        res = [int(np.ceil(s)) + 1 for s in scales]
        sizes = [int(-(-min(r ** 3, T) // 8) * 8) for r in res]
        return tuple(res), tuple(scales), tuple(sizes)
    res = [int(np.floor(base_resolution * growth ** l)) for l in range(L)]
    return (tuple(res), tuple(float(r) for r in res),
            tuple(min((r + 1) ** 3, T) for r in res))


class HashGridEncoding(nn.Module):
    """Multiresolution hash encoding: (..., 3) in [0, 1] -> (..., L·F).
    Tables level_0 ... level_{L-1}, (rows, F) each, start uniform in
    [0, 2e-4) (flax's uniform(2e-4)).

    tcnn_exact=True follows tiny-cuda-nn's GridEncoding layout so that
    converted tcnn checkpoints line up: its level scales and resolutions,
    the +0.5 half-cell offset, dense levels indexed x-fastest, table rows
    8-aligned. Both layouts share the spatial hash."""

    def __init__(self, n_levels: int = 16, features_per_level: int = 2,
                 log2_table_size: int = 19, base_resolution: int = 16,
                 max_resolution: int = 2048, tcnn_exact: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.tcnn_exact, self.dtype = (n_levels, tcnn_exact,
                                                      dtype)
        self.resolutions, self.scales, self.table_sizes = level_layout(
            n_levels, log2_table_size, base_resolution, max_resolution,
            tcnn_exact)
        for l, rows in enumerate(self.table_sizes):
            self.register_parameter(f"level_{l}", nn.Parameter(
                torch.rand((rows, features_per_level)) * 2e-4))
        self.register_buffer("corners", torch.from_numpy(_CORNERS),
                             persistent=False)

    def table(self, level: int) -> torch.Tensor:
        return getattr(self, f"level_{level}")

    def _index(self, c: torch.Tensor, level: int) -> torch.Tensor:
        """Integer corner coordinates (..., 3) int64 -> table rows."""
        res, size = self.resolutions[level], self.table_sizes[level]
        x, y, z = c[..., 0], c[..., 1], c[..., 2]
        if self.tcnn_exact and size >= res ** 3:        # dense, x fastest
            return (z * res + y) * res + x
        if not self.tcnn_exact and size == (res + 1) ** 3:   # dense
            return (x * (res + 1) + y) * (res + 1) + z
        h = x ^ ((y * _PRIMES[1]) & _MASK32) ^ ((z * _PRIMES[2]) & _MASK32)
        return h % size

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        # jnp.clip's gradient: half at a bound itself, as min/max's
        x01 = torch.minimum(torch.maximum(x01, x01.new_tensor(0.0)),
                            x01.new_tensor(1.0))
        feats = []
        for l in range(self.n_levels):
            res = self.resolutions[l]
            if self.tcnn_exact:
                # tcnn: pos = x·scale + 0.5, corners floor(pos) + {0, 1}
                # in a res-wide grid
                xs = x01 * self.scales[l] + 0.5
                x0 = torch.clamp_max(torch.floor(xs), res - 2)
            else:
                # the base cell clamped to res - 1, so that the +1 corners
                # stay in the (res + 1)-wide dense tables at x01 == 1
                xs = x01 * res
                x0 = torch.clamp_max(torch.floor(xs), res - 1)
            frac = (xs - x0).to(self.dtype)[..., None, :]        # (..., 1, 3)
            corners = self.corners
            idx = self._index(x0.long()[..., None, :] + corners, l)  # (..., 8)
            w = torch.where(corners.bool(), frac, 1.0 - frac)
            w = w[..., 0] * w[..., 1] * w[..., 2]                # (..., 8)
            rows = torch.index_select(self.table(l).to(self.dtype), 0,
                                      idx.reshape(-1))
            rows = rows.reshape(*idx.shape, -1)                  # (..., 8, F)
            feats.append((w[..., None] * rows).sum(-2))
        return torch.cat(feats, dim=-1)


class NeRFHTcnn(nn.Module):
    """The hash-grid NeRF-W field (reference NeRF_TCNN, nerfh_tcnn.py).

    sigma net: hash (L·2) -> 64 -> 1 + 15, ReLU sigma; colour net: geo 15
    + SH 16 [+ appearance latent, in_channels_a] -> 64 x 2 -> sigmoid rgb;
    transient net (encode_transient): geo 15 + SH 16 [+ transient latent,
    in_channels_t] -> 64 x 3 -> [sigmoid rgb, ReLU sigma, ReLU beta].
    in_channels_a / in_channels_t 0: the net takes no latent (the coarse
    field's, or no histogram encoding). Layers carry the flax names."""

    def __init__(self, bound: float = 25.0, geo_features: int = 15,
                 hidden: int = 64, encode_transient: bool = True,
                 in_channels_a: int = 5, in_channels_t: int = 2,
                 hash_level: int = 16, tcnn_exact: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bound, self.dtype = bound, dtype
        self.encode_transient = encode_transient
        self.encoder = HashGridEncoding(n_levels=hash_level,
                                        tcnn_exact=tcnn_exact, dtype=dtype)
        G, Hd = geo_features, hidden
        self.sigma_hidden = nn.Linear(hash_level * 2, Hd)
        self.sigma_out = nn.Linear(Hd, 1 + G)
        self.color_hidden0 = nn.Linear(G + 16 + in_channels_a, Hd)
        self.color_hidden1 = nn.Linear(Hd, Hd)
        self.color_out = nn.Linear(Hd, 3)
        if encode_transient:
            self.transient_hidden0 = nn.Linear(G + 16 + in_channels_t, Hd)
            self.transient_hidden1 = nn.Linear(Hd, Hd)
            self.transient_hidden2 = nn.Linear(Hd, Hd)
            self.transient_out = nn.Linear(Hd, 5)

    def forward(self, xyz: torch.Tensor, viewdir: torch.Tensor | None = None,
                a_latent: torch.Tensor | None = None,
                t_latent: torch.Tensor | None = None,
                sigma_only: bool = False,
                output_transient: bool = False) -> dict:
        dt = self.dtype
        x01 = (xyz + self.bound) / (2 * self.bound)   # nerfh_tcnn.py:151-156
        enc = self.encoder(x01)
        h = torch.relu(_dense(self.sigma_hidden, enc, dt))
        h = _dense(self.sigma_out, h, dt)
        out = {"static_sigma": torch.relu(h[..., 0]).float()}
        if sigma_only:
            return out
        geo = h[..., 1:]
        sh = spherical_harmonics_deg4(viewdir).to(dt)
        c = _with_latent([geo, sh], a_latent, dt)
        c = torch.relu(_dense(self.color_hidden0, c, dt))
        c = torch.relu(_dense(self.color_hidden1, c, dt))
        rgb = torch.sigmoid(_dense(self.color_out, c, dt))
        out["static_rgb"] = rgb.float()
        out["static_feat"] = rgb.new_zeros(rgb.shape[:-1] + (0,)).float()
        if not (self.encode_transient and output_transient):
            return out
        t = _with_latent([geo, sh], t_latent, dt)
        for i in range(3):
            t = torch.relu(_dense(getattr(self, f"transient_hidden{i}"), t,
                                  dt))
        t5 = _dense(self.transient_out, t, dt)
        out["transient_rgb"] = torch.sigmoid(t5[..., :3]).float()
        out["transient_sigma"] = torch.relu(t5[..., 3]).float()
        out["transient_beta"] = torch.relu(t5[..., 4]).float()
        return out


def _with_latent(parts: list, latent: torch.Tensor | None,
                 dt: torch.dtype) -> torch.Tensor:
    """parts concatenated along the last axis, the latent (..., La)
    broadcast over the leading axes of parts[0] and appended when given."""
    if latent is not None:
        lead = parts[0].shape[:-1]
        parts = parts + [torch.broadcast_to(latent.to(dt),
                                            lead + latent.shape[-1:])]
    return torch.cat([p.to(dt) for p in parts], dim=-1)
