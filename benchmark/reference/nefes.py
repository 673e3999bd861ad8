"""Plain float32 reference of the NeFeS feature field and its renderer:
the field MLP, the exposure MLP, FusionNet, the frequency embedding, the
rays, the stratified and importance samples, the NeRF-W composite, the
world rescale, the SE(3) pose update, the bicubic resize, the DFM cosine
loss, PSNR, SSIM and the stage-1 training loss.

A frozen copy of the plain (kernel-free) paths of the NeFeS paper's
method (Chen et al., CVPR 2024; github.com/ActiveVisionLab/NeFeS,
script/models/{nerfh_nff,rendering}.py), written once for this benchmark
and imported by nothing of the program. Every module keeps the layer
names of the program's modules, so one state dict loads into both.

`low=True` (the control) computes the field, the exposure MLP and
FusionNet in fp8 (e4m3), the step below the bfloat16 the configuration
states: the operands of their products, forward and backward (the
gradient scaled by its largest magnitude), are rounded to fp8 before an
f32 product, and each layer's output is stored in fp8, as the program
stores its layers' outputs in bf16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 128
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating at its largest value), in
    float32; the gradient passes the rounding unchanged."""
    q = x.detach().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    return x + (q - x.detach())


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-x.abs()))


class _Fp8Product(torch.autograd.Function):
    """x @ w.T with every operand of the forward and the backward products
    rounded to fp8 (the gradients of x and of w too)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8(x) @ fp8(w).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the gradient scaled to fp8's range by its largest magnitude (it
        # would flush to zero unscaled), as fp8 training recipes scale it
        s = FP8_MAX / g.abs().max().clamp_min(1e-30)
        g8 = fp8(g * s) / s
        gx = g8 @ fp8(w)
        gw = g8.reshape(-1, g.shape[-1]).t() @ fp8(x).reshape(-1, x.shape[-1])
        return gx, gw


def _dense(lin: nn.Linear, x: torch.Tensor, low: bool) -> torch.Tensor:
    if low:      # the product in fp8, its output stored in fp8
        return fp8(_Fp8Product.apply(x, lin.weight) + lin.bias)
    return x @ lin.weight.t() + lin.bias


class NeRFHNFF(nn.Module):
    """Coarse or fine NeFeS field: an 8-layer trunk with a skip at layer 4,
    a softplus density, a view-dependent rgb + feature head and, on the
    fine field, the NeRF-W transient branch."""

    def __init__(self, typ: str = "coarse", depth: int = 8, width: int = 128,
                 skips: tuple = (4,), in_channels_xyz: int = 63,
                 in_channels_dir: int = 27,
                 feature_dim: int = FEATURE_DIM):
        super().__init__()
        self.depth, self.skips = depth, tuple(skips)
        self.has_transient = typ == "fine"
        self.low = False
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

    def forward(self, xyz_emb, dir_emb=None, sigma_only=False,
                output_transient=True) -> dict:
        low = self.low
        h = xyz_emb
        for i in range(self.depth):
            lin = getattr(self, f"xyz_encoding_{i + 1}")
            if i in self.skips:
                h = torch.cat([xyz_emb, h], dim=-1)
            h = torch.relu(_dense(lin, h, low))
        out = {"static_sigma": softplus(_dense(self.static_sigma, h,
                                               low))[..., 0]}
        if sigma_only:
            return out
        final = _dense(self.xyz_encoding_final, h, low)
        fd = torch.cat([final, dir_emb], dim=-1)
        rgbfeat = _dense(self.static_rgb,
                         torch.relu(_dense(self.dir_encoding, fd, low)), low)
        out["static_rgb"] = rgbfeat[..., :3]
        out["static_feat"] = rgbfeat[..., 3:]
        if not (self.has_transient and output_transient):
            return out
        t = torch.relu(_dense(self.transient_encoding_1, fd, low))
        t = torch.relu(_dense(self.transient_encoding_2, t, low))
        t = torch.relu(_dense(self.transient_encoding_3, t, low))
        out["transient_sigma"] = softplus(
            _dense(self.transient_sigma, t, low))[..., 0]
        out["transient_rgb"] = torch.sigmoid(_dense(self.transient_rgb, t,
                                                    low))
        out["transient_beta"] = softplus(
            _dense(self.transient_beta, t, low))[..., 0]
        return out


class ExposureMLP(nn.Module):
    """Luminance histogram -> a 3x3 colour matrix and a bias (12)."""

    def __init__(self, hist_bin: int = 10, hidden: int = 32, layers: int = 3):
        super().__init__()
        self.layers, self.low = layers, False
        for i in range(layers):
            self.add_module(f"hidden_{i}",
                            nn.Linear(hist_bin if i == 0 else hidden, hidden))
        self.out = nn.Linear(hidden, 12)

    def forward(self, hist):
        h = hist
        for i in range(self.layers):
            h = torch.relu(_dense(getattr(self, f"hidden_{i}"), h, self.low))
        return _dense(self.out, h, self.low)


def affine_color_transform(e12: torch.Tensor, rgb: torch.Tensor):
    """sigmoid(K rgb + b); e12 (B, 12), rgb (B, N, 3) raw."""
    kernel = e12[..., :9].reshape(*e12.shape[:-1], 3, 3)
    out = torch.einsum("...ij,...nj->...ni", kernel, rgb) \
        + e12[..., 9:][..., None, :]
    return torch.sigmoid(out)


class FusionNet(nn.Module):
    """Four convolutions over the rendered rgb (ImageNet-normalised) and
    features, then BatchNorm on the input's own statistics: NHWC
    (B, H, W, 3 + F) -> (B, H, W, F)."""

    def __init__(self, feature_dim: int = FEATURE_DIM):
        super().__init__()
        self.low = False
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.conv0 = nn.Conv2d(3 + feature_dim, 64, 3, padding=1)
        self.conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, feature_dim, 5, padding=2)
        self.bn = nn.BatchNorm2d(feature_dim, eps=1e-5)

    def _conv(self, conv, h):
        if self.low:
            return fp8(F.conv2d(fp8(h), fp8(conv.weight), conv.bias,
                                padding=conv.padding))
        return F.conv2d(h, conv.weight, conv.bias, padding=conv.padding)

    def forward(self, x):
        rgb = (x[..., :3] - self.rgb_mean) / self.rgb_std
        h = torch.cat([rgb, x[..., 3:]], dim=-1).permute(0, 3, 1, 2)
        h = torch.relu(self._conv(self.conv0, h))
        h = torch.relu(self._conv(self.conv1, h))
        h = torch.relu(self._conv(self.conv2, h))
        h = self._conv(self.conv3, h)
        # batch statistics, biased variance E[h^2] - E[h]^2
        mean = h.mean((0, 2, 3))
        var = torch.clamp_min((h * h).mean((0, 2, 3)) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.bn.eps) * self.bn.weight
        h = (h - mean[:, None, None]) * mul[:, None, None] \
            + self.bn.bias[:, None, None]
        return h.permute(0, 2, 3, 1)


class NeFeS(nn.Module):
    """Coarse and fine fields, exposure MLP and FusionNet, named as the
    program's model bundle."""

    def __init__(self, depth=8, width=128, feature_dim=FEATURE_DIM,
                 skips=(4,), n_freqs_xyz=10, n_freqs_dir=4, hist_bin=10):
        super().__init__()
        self.n_freqs_xyz, self.n_freqs_dir = n_freqs_xyz, n_freqs_dir
        kw = dict(depth=depth, width=width, skips=skips,
                  in_channels_xyz=3 + 6 * n_freqs_xyz,
                  in_channels_dir=3 + 6 * n_freqs_dir,
                  feature_dim=feature_dim)
        self.coarse = NeRFHNFF("coarse", **kw)
        self.fine = NeRFHNFF("fine", **kw)
        self.exposure = ExposureMLP(hist_bin)
        self.fusion = FusionNet(feature_dim)

    def set_low(self, low: bool) -> "NeFeS":
        for m in (self.coarse, self.fine, self.exposure, self.fusion):
            m.low = low
        return self


# --- rays, samples, composite ---

def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...], f_k = 2^k."""
    freqs = torch.as_tensor(2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs),
                            dtype=torch.float32, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    flat = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(
        *x.shape[:-1], 6 * n_freqs)
    return torch.cat([x, flat], dim=-1)


def get_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """OpenGL pinhole rays of every pixel, each (H·W, 3)."""
    kw = dict(dtype=c2w.dtype, device=c2w.device)
    j, i = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], dim=-1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1).reshape(-1, 3)
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def rays_at(px, py, focal: float, H: int, W: int, c2w: torch.Tensor):
    """Rays at pixel coordinates px, py (B, N) of poses c2w (B, 3, 4)."""
    dirs = torch.stack([(px - W * 0.5) / focal, -(py - H * 0.5) / focal,
                        -torch.ones_like(px)], dim=-1)
    rays_d = torch.einsum("bnc,brc->bnr", dirs, c2w[:, :3, :3])
    return c2w[:, None, :3, 3].expand(rays_d.shape), rays_d


def stratified(n_rays: int, n: int, near: float, far: float, gen, device):
    """n z values a ray on [near, far], jittered in their intervals by
    uniforms from gen when gen is given."""
    t = torch.linspace(0.0, 1.0, n, device=device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n)
    if gen is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    u = torch.rand(z.shape, generator=gen, device=gen.device).to(device)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, n: int, gen):
    """Inverse-CDF samples: the 1e-5 weight floor, a right-searchsorted on
    the CDF and the 1e-5 denominator guard; evenly spaced uniforms without
    gen."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    shape = (cdf.shape[0], n)
    if gen is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(shape)
    else:
        u = torch.rand(shape, generator=gen, device=gen.device).to(cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def _alpha_weights(alphas):
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas[:, :-1]], dim=-1)
    trans = torch.cumprod(shifted, dim=-1)
    trans = torch.where(trans > 1e-24, trans, torch.zeros_like(trans))
    return alphas * trans, trans


def _deltas(z):
    d = z[:, 1:] - z[:, :-1]
    return torch.cat([d, torch.full_like(d[:, :1], 1e2)], dim=-1)


def composite(raw: dict, z, transient: bool, beta_min: float = 0.1) -> dict:
    """NeRF-W compositing with the feature head: the features take the
    weights without their gradient; with the transient heads, the joint
    transmittance and the beta map; without, the static-only path."""
    dl = _deltas(z)
    s_sig = raw["static_sigma"]
    if not transient:
        w, _ = _alpha_weights(1.0 - torch.exp(-dl * s_sig))
        return {"weights": w,
                "rgb": (w[..., None] * raw["static_rgb"]).sum(1),
                "feat": (w.detach()[..., None] * raw["static_feat"]).sum(1)}
    t_sig = raw["transient_sigma"]
    s_alpha = 1.0 - torch.exp(-dl * s_sig)
    t_alpha = 1.0 - torch.exp(-dl * t_sig)
    w, trans = _alpha_weights(1.0 - torch.exp(-dl * (s_sig + t_sig)))
    s_w, t_w = s_alpha * trans, t_alpha * trans
    rgb = ((s_w[..., None] * raw["static_rgb"]).sum(1)
           + (t_w[..., None] * raw["transient_rgb"]).sum(1))
    return {"weights": w, "rgb": rgb,
            "feat": (s_w.detach()[..., None] * raw["static_feat"]).sum(1),
            "beta": (t_w * raw["transient_beta"]).sum(1) + beta_min,
            "transient_sigmas": t_sig}


def render_rays(model: NeFeS, rays_o, rays_d, near, far, n_c: int, n_f: int,
                gen=None, train: bool = False) -> dict:
    """Coarse pass (density only at test time), importance samples from
    its weights, fine pass and composite. train: the coarse pass in full,
    the fine pass with the transient heads, jittered samples from gen."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    z = stratified(rays_o.shape[0], n_c, near, far, gen if train else None,
                   rays_o.device)
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    dir_emb_c = embed(viewdirs[:, None].expand(pts.shape), model.n_freqs_dir)
    xyz_c = embed(pts, model.n_freqs_xyz)
    if train:
        raw_c = model.coarse(xyz_c, dir_emb_c, False, False)
        out_c = composite(raw_c, z, transient=False)
    else:
        with torch.no_grad():
            raw_c = model.coarse(xyz_c, None, True, False)
            dl = _deltas(z)
            out_c = {"weights": _alpha_weights(
                1.0 - torch.exp(-dl * raw_c["static_sigma"]))[0]}
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_new = sample_pdf(z_mid, out_c["weights"][:, 1:-1].detach(), n_f,
                       gen if train else None).detach()
    z_f = torch.sort(torch.cat([z, z_new], dim=-1), dim=-1).values
    pts_f = rays_o[:, None] + rays_d[:, None] * z_f[..., None]
    raw_f = model.fine(embed(pts_f, model.n_freqs_xyz),
                       embed(viewdirs[:, None].expand(pts_f.shape),
                             model.n_freqs_dir), False, train)
    out = composite(raw_f, z_f, transient=train)
    if train:
        out["rgb0"] = out_c["rgb"]
    return out


def render_feature_image(model: NeFeS, pose34, hist, hwf, near, far, n_c,
                         n_f):
    """The refinement's render at (h, w): rgb after the exposure (h, w, 3)
    and FusionNet's features on the batch's own statistics (h, w, F)."""
    h, w, focal = hwf
    ro, rd = get_rays(h, w, focal, pose34)
    out = render_rays(model, ro, rd, near, far, n_c, n_f)
    rgb = affine_color_transform(model.exposure(hist[None]),
                                 out["rgb"][None])[0].reshape(h, w, 3)
    fused = model.fusion(torch.cat([rgb, out["feat"].reshape(h, w, -1)],
                                   dim=-1)[None])[0]
    return rgb, fused


# --- pose algebra ---

def fix_coord_supp(pose, ws_vec):
    """t = (t·scale + move)·scale2."""
    t = (pose[..., :3, 3] * ws_vec[0] + ws_vec[2:5]) * ws_vec[1]
    return torch.cat([pose[..., :3, :3], t[..., None]], dim=-1)


def _skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _series(theta, small_val, fn):
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, small_val, fn(safe))


def learn_pose(r, t, init34):
    """compose(SE3.exp([t, r]), init): R = exp(r) R_init, t = V(r) t +
    t_init."""
    theta = torch.sqrt((r * r).sum() + 1e-24)
    K = _skew(r)
    eye = torch.eye(3, device=r.device)
    sinc = _series(theta, 1.0 - theta * theta / 6.0,
                   lambda s: torch.sin(s) / s)
    cosc = _series(theta, 0.5 - theta * theta / 24.0,
                   lambda s: (1.0 - torch.cos(s)) / (s * s))
    vterm = _series(theta, 1.0 / 6.0 - theta * theta / 120.0,
                    lambda s: (s - torch.sin(s)) / s ** 3)
    R = eye + sinc * K + cosc * (K @ K)
    V = eye + cosc * K + vterm * (K @ K)
    return torch.cat([R @ init34[:, :3], (V @ t + init34[:, 3])[:, None]],
                     dim=1)


# --- images and losses ---

def _cubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) bicubic interpolation (A = -0.75, half-pixel centres,
    clamped borders)."""
    A = -0.75
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(np.int64)
    m = np.zeros((n_out, n_in), np.float64)
    for off in (-1, 0, 1, 2):
        t = np.abs(x - (x0 + off))
        w = np.where(t <= 1.0, ((A + 2) * t - (A + 3)) * t * t + 1,
                     np.where(t < 2.0, (((t - 5) * t + 8) * t - 4) * A, 0.0))
        np.add.at(m, (np.arange(n_out), np.clip(x0 + off, 0, n_in - 1)), w)
    return torch.tensor(m, dtype=torch.float32, device=device)


def resize_bicubic(img, H: int, W: int):
    """(h, w, C) -> (H, W, C), torch's bicubic."""
    mh = _cubic_matrix(img.shape[0], H, img.device)
    mw = _cubic_matrix(img.shape[1], W, img.device)
    return torch.einsum("Hh,hwc,Ww->HWc", mh, img, mw)


def _linear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) linear interpolation with align_corners=True."""
    x = (np.arange(n_out) * (n_in - 1) / (n_out - 1) if n_out > 1
         else np.zeros(1))
    i0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    m = np.zeros((n_out, n_in), np.float64)
    np.add.at(m, (np.arange(n_out), i0), 1.0 - (x - i0))
    np.add.at(m, (np.arange(n_out), i1), x - i0)
    return torch.tensor(m, dtype=torch.float32, device=device)


def resize_bilinear_ac(img, H: int, W: int):
    """(B, h, w, C) -> (B, H, W, C), bilinear with align_corners=True."""
    mh = _linear_matrix(img.shape[1], H, img.device)
    mw = _linear_matrix(img.shape[2], W, img.device)
    return torch.einsum("Hh,bhwc,Ww->bHWc", mh, img.float(), mw)


def cosine_loss(feat, target):
    """1 - the mean over channels of the cosine over pixels (norms
    sqrt(x + 1e-12))."""
    C = feat.shape[-1]
    a, b = feat.reshape(-1, C), target.reshape(-1, C)
    na = torch.sqrt((a * a).sum(0) + 1e-12)
    nb = torch.sqrt((b * b).sum(0) + 1e-12)
    return 1.0 - ((a * b).sum(0) / (na * nb)).mean()


def psnr(a, b):
    return -10.0 * torch.log10(torch.mean((a - b) ** 2))


def ssim_mean(x, y):
    """Mean SSIM of two (H, W, C) images: 7x7 means over reflection
    padding, C1 = 0.01², C2 = 0.03², clamped to [0, 1]."""
    x = F.pad(x.permute(2, 0, 1)[None], (3, 3, 3, 3), mode="reflect")
    y = F.pad(y.permute(2, 0, 1)[None], (3, 3, 3, 3), mode="reflect")

    def pool(a):
        return F.avg_pool2d(a, 7, stride=1)
    mx, my = pool(x), pool(y)
    sx, sy = pool(x * x) - mx * mx, pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    n = (2 * mx * my + 1e-4) * (2 * sxy + 9e-4)
    d = (mx ** 2 + my ** 2 + 1e-4) * (sx + sy + 9e-4)
    return torch.clamp(n / d, 0.0, 1.0).mean()


def luminance_histograms(images: torch.Tensor, bins: int = 10):
    """(B, H, W, 3) in [0, 1] -> (B, bins) rounded percent histograms of
    the BT.601 luma (a value of 1 in the last bin)."""
    y = (0.299 * images[..., 0] + 0.587 * images[..., 1]
         + 0.114 * images[..., 2]).reshape(images.shape[0], -1)
    idx = torch.clamp((y * bins).long(), 0, bins - 1)
    counts = torch.zeros(images.shape[0], bins, device=images.device)
    counts.scatter_add_(1, idx, torch.ones_like(y))
    return torch.round(counts / y.shape[1] * 100.0)


def training_loss(out: dict, target_rgb, target_feat, lambda_u=0.01,
                  feat_weight=0.04):
    """Stage 1: NeRF-W's colour terms (0.5 coarse MSE, beta-weighted fine
    MSE, log beta + 3, lambda_u · mean transient sigma) plus 0.04 · L1 of
    the features. Returns (the loss, the L1 term)."""
    beta = out["beta"]
    loss = 0.5 * torch.mean((out["rgb0"] - target_rgb) ** 2)
    loss = loss + torch.mean((out["rgb"] - target_rgb) ** 2
                             / (2.0 * beta[..., None] ** 2))
    loss = loss + 3.0 + torch.mean(torch.log(beta))
    loss = loss + lambda_u * torch.mean(out["transient_sigmas"])
    loss_feat = torch.mean(torch.abs(out["feat"] - target_feat))
    return loss + feat_weight * loss_feat, loss_feat
