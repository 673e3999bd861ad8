"""NeRFH-NFF feature field, exposure MLP and FusionNet as torch modules;
port of nefes_tpu/fields/nerfh_nff.py.

Parameters are f32; the forward casts inputs and weights to the compute
dtype (bf16 on the card) and rounds where flax's Dense(dtype=...) does:
each product and each bias add returns the compute dtype. Layers carry
the flax names (``xyz_encoding_1`` ...) so that weights.py maps the flax
tree one to one. A flax SplitDense (a Dense over a concat, computed as two
matmuls) is one nn.Linear over the concatenated input whose weight is
split by columns in the forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 128
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (no threshold). Its
    gradient is sigmoid(x) at x = 0 too: max(x, 0) passes half there."""
    return (torch.maximum(x, x.new_zeros(()))
            + torch.log1p(torch.exp(-x.abs())))


def _dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) @ lin.weight.to(dt).t() + lin.bias.to(dt)


def _split_dense(lin: nn.Linear, a: torch.Tensor, b: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    """lin over the concat [a, b] as a @ W_a + b @ W_b + bias."""
    w = lin.weight.to(dt)
    da = a.shape[-1]
    return (a.to(dt) @ w[:, :da].t() + b.to(dt) @ w[:, da:].t()
            + lin.bias.to(dt))


class NeRFHNFF(nn.Module):
    """Coarse or fine NeFeS field MLP. Returns a dict of named heads:
    static_sigma (softplus, f32), static_rgb / static_feat (linear, in
    head_dtype) and, for the fine field with output_transient, the NeRF-W
    transient heads."""

    def __init__(self, typ: str = "coarse", depth: int = 8, width: int = 128,
                 skips: tuple[int, ...] = (4,), in_channels_xyz: int = 63,
                 in_channels_dir: int = 27, feature_dim: int = FEATURE_DIM,
                 encode_transient: bool | None = None,
                 dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype | None = None):
        super().__init__()
        self.typ, self.depth, self.width = typ, depth, width
        self.skips = tuple(skips)
        self.feature_dim = feature_dim
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.has_transient = (typ == "fine" if encode_transient is None
                              else encode_transient)
        E, Ed, W, H = in_channels_xyz, in_channels_dir, width, width // 2
        for i in range(depth):
            n_in = (E if i == 0 else W) + (E if i in self.skips else 0)
            self.add_module(f"xyz_encoding_{i + 1}", nn.Linear(n_in, W))
        self.static_sigma = nn.Linear(W, 1)
        self.xyz_encoding_final = nn.Linear(W, W)
        self.dir_encoding = nn.Linear(W + Ed, H)
        self.static_rgb = nn.Linear(H, 3 + feature_dim)
        if self.has_transient:
            self.transient_encoding_1 = nn.Linear(W + Ed, H)
            self.transient_encoding_2 = nn.Linear(H, H)
            self.transient_encoding_3 = nn.Linear(H, H)
            self.transient_sigma = nn.Linear(H, 1)
            self.transient_rgb = nn.Linear(H, 3)
            self.transient_beta = nn.Linear(H, 1)

    def layer(self, i: int) -> nn.Linear:
        return getattr(self, f"xyz_encoding_{i + 1}")

    def forward(self, xyz_emb: torch.Tensor,
                dir_emb: torch.Tensor | None = None,
                sigma_only: bool = False,
                output_transient: bool = True) -> dict:
        dt = self.dtype
        x = xyz_emb.to(dt)
        h = x
        for i in range(self.depth):
            if i in self.skips:
                h = _split_dense(self.layer(i), x, h, dt)
            else:
                h = _dense(self.layer(i), h, dt)
            h = torch.relu(h)

        sigma = softplus(_dense(self.static_sigma, h, dt))[..., 0]
        out = {"static_sigma": sigma.float()}
        if sigma_only:
            return out

        hd = self.head_dtype if self.head_dtype is not None else torch.float32
        final = _dense(self.xyz_encoding_final, h, dt)
        de = dir_emb.to(dt)
        dir_enc = torch.relu(_split_dense(self.dir_encoding, final, de, dt))
        rgbfeat = _dense(self.static_rgb, dir_enc, dt)
        out["static_rgb"] = rgbfeat[..., :3].to(hd)
        out["static_feat"] = rgbfeat[..., 3:].to(hd)
        if not (self.has_transient and output_transient):
            return out

        t = torch.relu(_split_dense(self.transient_encoding_1, final, de, dt))
        t = torch.relu(_dense(self.transient_encoding_2, t, dt))
        t = torch.relu(_dense(self.transient_encoding_3, t, dt))
        out["transient_sigma"] = softplus(
            _dense(self.transient_sigma, t, dt))[..., 0].float()
        out["transient_rgb"] = torch.sigmoid(
            _dense(self.transient_rgb, t, dt)).to(hd)
        out["transient_beta"] = softplus(
            _dense(self.transient_beta, t, dt))[..., 0].float()
        return out


class ExposureMLP(nn.Module):
    """Luminance histogram -> 3x3 affine colour kernel + bias (12)."""

    def __init__(self, hist_bin: int = 10, hidden: int = 32, layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        for i in range(layers):
            self.add_module(f"hidden_{i}",
                            nn.Linear(hist_bin if i == 0 else hidden, hidden))
        self.out = nn.Linear(hidden, 12)

    def forward(self, hist: torch.Tensor) -> torch.Tensor:
        h = hist
        for i in range(self.layers):
            h = torch.relu(_dense(getattr(self, f"hidden_{i}"), h, self.dtype))
        return _dense(self.out, h, self.dtype).float()


def affine_color_transform(embedding12: torch.Tensor,
                           rgb: torch.Tensor) -> torch.Tensor:
    """sigmoid(K·rgb + b); embedding12 (B, 12), rgb (B, N, 3) raw."""
    kernel = embedding12[..., :9].reshape(*embedding12.shape[:-1], 3, 3)
    bias = embedding12[..., 9:]
    out = torch.einsum("...ij,...nj->...ni", kernel, rgb) + bias[..., None, :]
    return torch.sigmoid(out)


class FusionNet(nn.Module):
    """4-layer CNN fusing rendered RGB + features -> refined features.
    Takes and returns NHWC (B, H, W, 3 + F) -> (B, H, W, F) f32; RGB is
    ImageNet-normalised first; BatchNorm after the last conv unless no_bn.
    """

    def __init__(self, feature_dim: int = FEATURE_DIM, residual: bool = False,
                 no_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual, self.no_bn, self.dtype = residual, no_bn, dtype
        # the ImageNet statistics live on the module's device: a copy
        # from the host on every call could not be captured in a CUDA graph
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.conv0 = nn.Conv2d(3 + feature_dim, 64, 3, padding=1)
        self.conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, feature_dim, 5, padding=2)
        if not no_bn:
            # flax BatchNorm(momentum=0.9) is torch momentum 0.1
            self.bn = nn.BatchNorm2d(feature_dim, eps=1e-5, momentum=0.1)

    def _conv(self, conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt),
                        padding=conv.padding)

    def forward(self, x: torch.Tensor, use_batch_stats: bool = False,
                train: bool = False):
        """use_batch_stats: normalise with this input's batch statistics
        (running averages left untouched) instead of the running ones.
        train: normalise with the batch statistics and return (h, the
        running averages flax's BatchNorm(momentum=0.9) stores after this
        batch, {"running_mean", "running_var"} detached, or None without
        BN); the caller applies them (train_step_patch does, after the
        step), as the JAX step persists its new batch_stats."""
        mean = self.rgb_mean.to(x.dtype)
        std = self.rgb_std.to(x.dtype)
        rgb = (x[..., :3] - mean) / std
        h = torch.cat([rgb, x[..., 3:]], dim=-1).to(self.dtype)
        h = h.permute(0, 3, 1, 2)                                  # NCHW
        h = torch.relu(self._conv(self.conv0, h))
        h = torch.relu(self._conv(self.conv1, h))
        h = torch.relu(self._conv(self.conv2, h))
        h = self._conv(self.conv3, h)
        new_stats = None
        if not self.no_bn:
            bn = self.bn
            if use_batch_stats or train:
                h, mean_b, var_b = self._batch_norm(h)
                if train:
                    m = 0.9
                    new_stats = {
                        "running_mean": (m * bn.running_mean
                                         + (1 - m) * mean_b).detach(),
                        "running_var": (m * bn.running_var
                                        + (1 - m) * var_b).detach()}
            else:
                h = F.batch_norm(h.float(), bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, training=False,
                                 eps=bn.eps).to(self.dtype)
        h = h.float().permute(0, 2, 3, 1)                          # NHWC
        if self.residual:
            h = x[..., 3:] + h
        return (h, new_stats) if train else h

    def _batch_norm(self, h: torch.Tensor):
        """flax BatchNorm with batch statistics: mean and the biased
        variance E[h^2] - E[h]^2 (clipped at 0) in f32, over N, H, W;
        output in the compute dtype. Returns (out, mean, var)."""
        bn = self.bn
        hf = h.float()
        axes = (0, 2, 3)
        mean = hf.mean(axes)
        var = torch.clamp_min((hf * hf).mean(axes) - mean * mean, 0.0)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        out = (hf - mean[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        return out.to(self.dtype), mean, var
