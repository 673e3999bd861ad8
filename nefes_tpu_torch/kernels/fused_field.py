"""Fused NeRFH-NFF field: the MLP tower and its heads, as hand-written
Hopper kernels (csrc/fused_field.cu) with a plain PyTorch version of each,
on pre-embedded inputs (K1, K2) or on raw points and directions (K5, K6).

  K1 field_fwd_pre  replaces nefes_tpu/kernels/fused_field.py:_run_fwd_pre
                    (_fwd_kernel_pre, _tower_tile)
  K2 field_bwd_pre  replaces _run_bwd_pre (_bwd_kernel_pre, _mlp_backward
                    with pre=True) for the frozen field (need_dw=False):
                    it recomputes the tower and returns only the embedding
                    cotangents
  K5 field_fwd      replaces _run_fwd (_fwd_kernel, _embed_block): the
                    frequency embedding computed in the kernel, heads in f32
  K6 field_bwd      replaces _run_bwd (_bwd_kernel, _mlp_backward with
                    pre=False) for the frozen field: d_pts, d_dirs in f32

All four follow _tower_tile's rounding points: hidden layers accumulate in
f32 and round to the pack dtype, then take the bias and the ReLU in the
pack dtype; the heads accumulate in f32. K1/K2 write heads and embedding
cotangents in the pack dtype, K5/K6 (as the TPU kernels) take and give f32.
K5/K6 embed in f32 (exact phases x·2^k, full-precision sin/cos, rounded to
the pack dtype) in the reference channel order, so all kernels read the one
PackedField layout. Each wrapper runs its kernel for a CUDA tensor and its
plain version for a CPU tensor; it counts kernel launches in
``<wrapper>.launches``. Modes: "sigma" (coarse pass at test time) and
"full" (sigma + rgb + features). The transient heads ("transient" mode)
and the weight gradients (need_dw=True) are not in these kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from nefes_tpu_torch.fields.embedder import EmbedConfig, embed
from nefes_tpu_torch.kernels import build

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class FieldSpec:
    """Static shape description of one NeRFH-NFF tower (the JAX package's
    FieldSpec without its TPU tile size)."""

    depth: int = 8
    width: int = 128
    skips: tuple[int, ...] = (4,)
    n_freqs_xyz: int = 10
    n_freqs_dir: int = 4
    feature_dim: int = 128
    transient: bool = False          # fine tower has transient heads
    dtype: str = "bfloat16"          # pack dtype ("float32" for parity tests)

    @property
    def emb_xyz(self) -> int:
        return 3 + 6 * self.n_freqs_xyz

    @property
    def emb_dir(self) -> int:
        return 3 + 6 * self.n_freqs_dir

    @property
    def half(self) -> int:
        return self.width // 2

    @property
    def rgbfeat(self) -> int:
        return 3 + self.feature_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def skipmask(self) -> int:
        return sum(1 << i for i in self.skips if 0 < i < self.depth)

    @classmethod
    def from_model(cls, model_cfg, typ: str, **kw) -> "FieldSpec":
        """Build from a train.ModelConfig."""
        return cls(depth=model_cfg.depth, width=model_cfg.width,
                   skips=tuple(model_cfg.skips),
                   n_freqs_xyz=model_cfg.xyz_embed.num_freqs,
                   n_freqs_dir=model_cfg.dir_embed.num_freqs,
                   feature_dim=model_cfg.feature_dim,
                   transient=(typ == "fine"), **kw)


def weight_names(spec: FieldSpec) -> list[str]:
    """Packed array order, as in the JAX package."""
    names = []
    for i in range(spec.depth):
        if i == 0:
            names += [f"l{i}_we"]
        elif i in spec.skips:
            names += [f"l{i}_we", f"l{i}_wh"]
        else:
            names += [f"l{i}_wh"]
        names += [f"l{i}_b"]
    names += ["sig_w", "sig_b", "fin_w", "fin_b",
              "dir_wh", "dir_wd", "dir_b", "rgb_w", "rgb_b"]
    if spec.transient:
        names += ["t1_wh", "t1_wd", "t1_b", "t2_w", "t2_b", "t3_w", "t3_b",
                  "ts_w", "ts_b", "tr_w", "tr_b", "tb_w", "tb_b"]
    return names


@dataclass(frozen=True)
class PackedField:
    """Frozen tower weights as the kernels read them.

    weights: name -> tensor in weight_names order; matrices (in, out) in
    the pack dtype, biases (out,) f32. w / wt: every matrix of the static
    tower (no transient heads), in weight_names order, flattened into one
    blob, (in, out) and transposed (out, in) at the same offsets. b: the
    static biases in one f32 blob."""

    spec: FieldSpec
    weights: dict
    w: torch.Tensor
    wt: torch.Tensor
    b: torch.Tensor


def pack_params(tower, spec: FieldSpec) -> PackedField:
    """A torch NeRFHNFF -> PackedField. Linear weights (out, in) become
    (in, out) matrices; the skip and dir layers (one Linear over a concat)
    are split into their row blocks. The rows keep the reference embedding
    order, the only layout the kernels read (the raw-input kernels embed in
    that order; the TPU package permutes rows for its raw kernels)."""
    dt = spec.torch_dtype
    E, W = spec.emb_xyz, spec.width

    def k(name):
        return getattr(tower, name).weight.detach().t()

    def b(name):
        return getattr(tower, name).bias.detach().float().contiguous()

    out = {}
    for i in range(spec.depth):
        kern = k(f"xyz_encoding_{i + 1}")
        if i == 0:
            out[f"l{i}_we"] = kern
        elif i in spec.skips:
            out[f"l{i}_we"], out[f"l{i}_wh"] = kern[:E], kern[E:]
        else:
            out[f"l{i}_wh"] = kern
        out[f"l{i}_b"] = b(f"xyz_encoding_{i + 1}")
    out["sig_w"], out["sig_b"] = k("static_sigma"), b("static_sigma")
    out["fin_w"] = k("xyz_encoding_final")
    out["fin_b"] = b("xyz_encoding_final")
    dk = k("dir_encoding")
    out["dir_wh"], out["dir_wd"] = dk[:W], dk[W:]
    out["dir_b"] = b("dir_encoding")
    out["rgb_w"], out["rgb_b"] = k("static_rgb"), b("static_rgb")
    if spec.transient:
        tk = k("transient_encoding_1")
        out["t1_wh"], out["t1_wd"] = tk[:W], tk[W:]
        out["t1_b"] = b("transient_encoding_1")
        for n, m in (("t2", "transient_encoding_2"),
                     ("t3", "transient_encoding_3"),
                     ("ts", "transient_sigma"), ("tr", "transient_rgb"),
                     ("tb", "transient_beta")):
            out[f"{n}_w"], out[f"{n}_b"] = k(m), b(m)
    weights = {n: (v if n.endswith("_b") else v.to(dt).contiguous())
               for n, v in out.items()}
    static = weight_names(replace(spec, transient=False))
    mats = [weights[n] for n in static if not n.endswith("_b")]
    return PackedField(
        spec=spec, weights=weights,
        w=torch.cat([m.reshape(-1) for m in mats]),
        wt=torch.cat([m.t().reshape(-1) for m in mats]),
        b=torch.cat([weights[n] for n in static if n.endswith("_b")]))


# --------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, written with torch ops)
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor, cd=None) -> torch.Tensor:
    """a @ w with f32 accumulation, rounded to cd when given."""
    out = a.float() @ w.float()
    return out if cd is None else out.to(cd)


def _mm_t(g: torch.Tensor, w: torch.Tensor, cd=None) -> torch.Tensor:
    """g @ w^T with f32 accumulation, rounded to cd when given."""
    out = g.float() @ w.float().t()
    return out if cd is None else out.to(cd)


def tower_plain(p: PackedField, full: bool, emb: torch.Tensor,
                embd: torch.Tensor | None):
    """_tower_tile on pre-embedded inputs in the pack dtype: returns
    (zs (N,) f32 sigma pre-activation, rgbfeat (N, 3+F) f32 | None,
    activations for the backward)."""
    spec, w = p.spec, p.weights
    cd = spec.torch_dtype
    acts = {"emb": emb}
    h = emb
    for i in range(spec.depth):
        z = _mm(h if i else emb, w[f"l{i}_wh" if i else f"l{i}_we"], cd)
        if i and i in spec.skips:
            z = z + _mm(emb, w[f"l{i}_we"], cd)
        h = torch.relu(z + w[f"l{i}_b"].to(cd))
        acts[f"h{i}"] = h
    zs = (_mm(h, w["sig_w"]) + w["sig_b"])[:, 0]
    acts["zs"] = zs
    if not full:
        return zs, None, acts
    final = _mm(h, w["fin_w"], cd) + w["fin_b"].to(cd)
    zd = (_mm(final, w["dir_wh"], cd) + _mm(embd, w["dir_wd"], cd)
          + w["dir_b"].to(cd))
    de = torch.relu(zd)
    acts["final"], acts["de"] = final, de
    return zs, _mm(de, w["rgb_w"]) + w["rgb_b"], acts


def tower_backward_plain(p: PackedField, full: bool, acts: dict,
                         g_sigma: torch.Tensor,
                         g_rgbfeat: torch.Tensor | None):
    """_mlp_backward with pre=True and need_dw=False. g_sigma (N,) is the
    cotangent of softplus(zs), g_rgbfeat (N, 3+F) that of the rgb/feature
    head. Returns (d_emb (N, E) f32, d_embd (N, Ed) f32 | None)."""
    spec, w = p.spec, p.weights
    cd = spec.torch_dtype
    dzs = g_sigma.float() * torch.sigmoid(acts["zs"])        # softplus'
    dh = _mm_t(dzs[:, None].to(cd), w["sig_w"], cd)
    d_embd = None
    if full:
        dde = _mm_t(g_rgbfeat.to(cd), w["rgb_w"], cd)
        dzd = dde * (acts["de"] > 0)
        d_final = _mm_t(dzd, w["dir_wh"], cd)
        d_embd = _mm_t(dzd, w["dir_wd"])
        dh = dh + _mm_t(d_final, w["fin_w"], cd)
    d_emb = torch.zeros(acts["emb"].shape, dtype=torch.float32,
                        device=dh.device)
    for i in range(spec.depth - 1, -1, -1):
        dz = dh * (acts[f"h{i}"] > 0)
        if i == 0:
            d_emb = d_emb + _mm_t(dz, w["l0_we"])
        else:
            dh = _mm_t(dz, w[f"l{i}_wh"], cd)
            if i in spec.skips:
                d_emb = d_emb + _mm_t(dz, w[f"l{i}_we"])
    return d_emb, d_embd


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def field_fwd_pre_plain(p: PackedField, full: bool, emb: torch.Tensor,
                        embd: torch.Tensor | None):
    """K1's function: (sigma (N,), rgb (N, 3) | None, feat (N, F) | None),
    all in the pack dtype."""
    cd = p.spec.torch_dtype
    zs, rf, _ = tower_plain(p, full, emb, embd)
    sigma = _softplus(zs).to(cd)
    if not full:
        return sigma, None, None
    return sigma, rf[:, :3].to(cd), rf[:, 3:].to(cd)


def field_bwd_pre_plain(p: PackedField, full: bool, emb, embd, g_sigma,
                        g_rgb, g_feat):
    """K2's function: recompute the tower, backprop the head cotangents
    (pack dtype) to (d_emb, d_embd | None) in the pack dtype."""
    cd = p.spec.torch_dtype
    _, _, acts = tower_plain(p, full, emb, embd)
    g_rf = torch.cat([g_rgb, g_feat], dim=1) if full else None
    d_emb, d_embd = tower_backward_plain(p, full, acts, g_sigma, g_rf)
    return d_emb.to(cd), (d_embd.to(cd) if full else None)


def embed_plain(x: torch.Tensor, n_freqs: int, cd) -> torch.Tensor:
    """_embed_block: x (N, 3) f32 -> (N, 3 + 6·n_freqs) in the reference
    order, f32 phases and sin/cos rounded to cd."""
    return embed(x.float(), EmbedConfig(num_freqs=n_freqs)).to(cd)


def embed_backward_plain(d_e: torch.Tensor, x: torch.Tensor,
                         n_freqs: int) -> torch.Tensor:
    """The d_embed step of _mlp_backward: the embedding cotangent d_e
    (N, 3 + 6·n_freqs) f32 back to x (N, 3), in f32, the phases recomputed
    from x."""
    out = d_e[:, :3]
    for k in range(n_freqs):
        ph = x * 2.0 ** k
        d_sin, d_cos = d_e[:, 3 + 6 * k:6 + 6 * k], d_e[:, 6 + 6 * k:9 + 6 * k]
        out = out + (d_sin * torch.cos(ph) - d_cos * torch.sin(ph)) * 2.0 ** k
    return out


def _embed_raw(p: PackedField, full: bool, pts, dirs):
    spec, cd = p.spec, p.spec.torch_dtype
    emb = embed_plain(pts, spec.n_freqs_xyz, cd)
    return emb, (embed_plain(dirs, spec.n_freqs_dir, cd) if full else None)


def field_fwd_plain(p: PackedField, full: bool, pts: torch.Tensor,
                    dirs: torch.Tensor | None):
    """K5's function: pts, dirs (N, 3) f32 -> (sigma (N,), rgb (N, 3) |
    None, feat (N, F) | None), all f32."""
    zs, rf, _ = tower_plain(p, full, *_embed_raw(p, full, pts, dirs))
    sigma = _softplus(zs)
    if not full:
        return sigma, None, None
    return sigma, rf[:, :3], rf[:, 3:]


def field_bwd_plain(p: PackedField, full: bool, pts, dirs, g_sigma, g_rgb,
                    g_feat):
    """K6's function: recompute the tower, backprop the f32 head
    cotangents to (d_pts (N, 3), d_dirs (N, 3) | None) in f32."""
    spec = p.spec
    _, _, acts = tower_plain(p, full, *_embed_raw(p, full, pts, dirs))
    g_rf = torch.cat([g_rgb, g_feat], dim=1) if full else None
    d_emb, d_embd = tower_backward_plain(p, full, acts, g_sigma, g_rf)
    d_pts = embed_backward_plain(d_emb, pts, spec.n_freqs_xyz)
    if not full:
        return d_pts, None
    return d_pts, embed_backward_plain(d_embd, dirs, spec.n_freqs_dir)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_packed(p: PackedField, device: torch.device) -> None:
    spec = p.spec
    if spec.width % 32 or spec.depth > 16:
        raise ValueError("the kernels take width % 32 == 0, depth <= 16")
    cd = spec.torch_dtype
    check(p.w, "w", p.w.shape, cd, device)
    check(p.wt, "wt", p.w.shape, cd, device)
    check(p.b, "b", p.b.shape, torch.float32, device)


def dims(spec: FieldSpec) -> tuple:
    return (spec.depth, spec.width, spec.skipmask, spec.emb_xyz,
            spec.emb_dir, spec.feature_dim)


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def field_fwd_pre(p: PackedField, full: bool, emb: torch.Tensor,
                  embd: torch.Tensor | None):
    """K1: the tower forward. emb (N, E), embd (N, Ed) in the pack dtype.
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if emb.device.type == "cpu":
        return field_fwd_pre_plain(p, full, emb, embd)
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for device {emb.device}")
    spec, dev, cd = p.spec, emb.device, p.spec.torch_dtype
    n = emb.shape[0]
    check_packed(p, dev)
    check(emb, "emb", (n, spec.emb_xyz), cd, dev)
    if full:
        check(embd, "embd", (n, spec.emb_dir), cd, dev)
    sigma = torch.empty(n, dtype=cd, device=dev)
    rgb = torch.empty((n, 3), dtype=cd, device=dev) if full else None
    feat = (torch.empty((n, spec.feature_dim), dtype=cd, device=dev)
            if full else None)
    lib = build.library("fused_field")
    err = lib.nefes_field_fwd_pre(
        _DTYPE_CODE[cd], int(full), n, emb.data_ptr(), _ptr(embd),
        p.w.data_ptr(), p.b.data_ptr(), *dims(spec), sigma.data_ptr(),
        _ptr(rgb), _ptr(feat), _stream())
    field_fwd_pre.launches += 1
    raise_on(err, "field_fwd_pre")
    return sigma, rgb, feat


def field_bwd_pre(p: PackedField, full: bool, emb, embd, g_sigma, g_rgb,
                  g_feat):
    """K2: recompute the tower and backprop the head cotangents (pack
    dtype) to (d_emb, d_embd | None) in the pack dtype."""
    if emb.device.type == "cpu":
        return field_bwd_pre_plain(p, full, emb, embd, g_sigma, g_rgb,
                                   g_feat)
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for device {emb.device}")
    spec, dev, cd = p.spec, emb.device, p.spec.torch_dtype
    n = emb.shape[0]
    check_packed(p, dev)
    check(emb, "emb", (n, spec.emb_xyz), cd, dev)
    check(g_sigma, "g_sigma", (n,), cd, dev)
    if full:
        check(embd, "embd", (n, spec.emb_dir), cd, dev)
        check(g_rgb, "g_rgb", (n, 3), cd, dev)
        check(g_feat, "g_feat", (n, spec.feature_dim), cd, dev)
    d_emb = torch.empty((n, spec.emb_xyz), dtype=cd, device=dev)
    d_embd = (torch.empty((n, spec.emb_dir), dtype=cd, device=dev)
              if full else None)
    lib = build.library("fused_field")
    err = lib.nefes_field_bwd_pre(
        _DTYPE_CODE[cd], int(full), n, emb.data_ptr(), _ptr(embd),
        p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(), *dims(spec),
        g_sigma.data_ptr(), _ptr(g_rgb), _ptr(g_feat), d_emb.data_ptr(),
        _ptr(d_embd), _stream())
    field_bwd_pre.launches += 1
    raise_on(err, "field_bwd_pre")
    return d_emb, d_embd


def field_fwd(p: PackedField, full: bool, pts: torch.Tensor,
              dirs: torch.Tensor | None):
    """K5: the tower forward on raw pts, dirs (N, 3) f32, embedding in the
    kernel; heads in f32. The kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if pts.device.type == "cpu":
        return field_fwd_plain(p, full, pts, dirs)
    if pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {pts.device}")
    spec, dev, f32 = p.spec, pts.device, torch.float32
    n = pts.shape[0]
    check_packed(p, dev)
    check(pts, "pts", (n, 3), f32, dev)
    if full:
        check(dirs, "dirs", (n, 3), f32, dev)
    sigma = torch.empty(n, dtype=f32, device=dev)
    rgb = torch.empty((n, 3), dtype=f32, device=dev) if full else None
    feat = (torch.empty((n, spec.feature_dim), dtype=f32, device=dev)
            if full else None)
    lib = build.library("fused_field")
    err = lib.nefes_field_fwd_raw(
        _DTYPE_CODE[spec.torch_dtype], int(full), n, pts.data_ptr(),
        _ptr(dirs), p.w.data_ptr(), p.b.data_ptr(), *dims(spec),
        sigma.data_ptr(), _ptr(rgb), _ptr(feat), _stream())
    field_fwd.launches += 1
    raise_on(err, "field_fwd")
    return sigma, rgb, feat


def field_bwd(p: PackedField, full: bool, pts, dirs, g_sigma, g_rgb,
              g_feat):
    """K6: recompute the tower on raw inputs and backprop the f32 head
    cotangents to (d_pts (N, 3), d_dirs (N, 3) | None) in f32."""
    if pts.device.type == "cpu":
        return field_bwd_plain(p, full, pts, dirs, g_sigma, g_rgb, g_feat)
    if pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {pts.device}")
    spec, dev, f32 = p.spec, pts.device, torch.float32
    n = pts.shape[0]
    check_packed(p, dev)
    check(pts, "pts", (n, 3), f32, dev)
    check(g_sigma, "g_sigma", (n,), f32, dev)
    if full:
        check(dirs, "dirs", (n, 3), f32, dev)
        check(g_rgb, "g_rgb", (n, 3), f32, dev)
        check(g_feat, "g_feat", (n, spec.feature_dim), f32, dev)
    d_pts = torch.empty((n, 3), dtype=f32, device=dev)
    d_dirs = torch.empty((n, 3), dtype=f32, device=dev) if full else None
    lib = build.library("fused_field")
    err = lib.nefes_field_bwd_raw(
        _DTYPE_CODE[spec.torch_dtype], int(full), n, pts.data_ptr(),
        _ptr(dirs), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
        *dims(spec), g_sigma.data_ptr(), _ptr(g_rgb), _ptr(g_feat),
        d_pts.data_ptr(), _ptr(d_dirs), _stream())
    field_bwd.launches += 1
    raise_on(err, "field_bwd")
    return d_pts, d_dirs


for _k in (field_fwd_pre, field_bwd_pre, field_fwd, field_bwd):
    _k.launches = 0


class _Field(torch.autograd.Function):
    """Frozen-field tower, differentiable in its inputs only: the
    embeddings (K1/K2) or, raw, the points and directions (K5/K6)."""

    @staticmethod
    def forward(ctx, raw, p, full, x, dirs):
        ctx.raw, ctx.p, ctx.full = raw, p, full
        ctx.save_for_backward(x, dirs)
        return (field_fwd if raw else field_fwd_pre)(p, full, x, dirs)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_feat):
        x, dirs = ctx.saved_tensors
        hd = torch.float32 if ctx.raw else ctx.p.spec.torch_dtype
        n = x.shape[0]

        def ct(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=hd, device=x.device)
            return g.to(hd).contiguous()

        g_sigma = ct(g_sigma, (n,))
        if ctx.full:
            g_rgb = ct(g_rgb, (n, 3))
            g_feat = ct(g_feat, (n, ctx.p.spec.feature_dim))
        bwd = field_bwd if ctx.raw else field_bwd_pre
        d_x, d_dirs = bwd(ctx.p, ctx.full, x, dirs, g_sigma, g_rgb, g_feat)
        return None, None, None, d_x, d_dirs


def _check_options(spec: FieldSpec, sigma_only: bool, output_transient: bool,
                   need_dw: bool) -> None:
    if need_dw:
        raise NotImplementedError(
            "weight gradients through the fused field (need_dw=True) are "
            "not ported; the kernels serve the frozen field")
    if not sigma_only and spec.transient and output_transient:
        raise NotImplementedError(
            "the transient heads are not in the fused field kernels")


def _heads(spec: FieldSpec, lead, sigma, rgb, feat) -> dict:
    out = {"static_sigma": sigma.reshape(lead)}
    if rgb is not None:
        out["static_rgb"] = rgb.reshape(*lead, 3)
        out["static_feat"] = feat.reshape(*lead, spec.feature_dim)
    return out


def fused_field_apply_pre(spec: FieldSpec, packed: PackedField,
                          xyz_emb: torch.Tensor,
                          dir_emb: torch.Tensor | None = None,
                          sigma_only: bool = False,
                          output_transient: bool = True,
                          need_dw: bool = False) -> dict:
    """Drop-in for NeRFHNFF on EMBEDDED inputs: the signature of the
    model's field fns, returning the same named heads in the pack dtype.

    xyz_emb (..., E); dir_emb (..., Ed) broadcastable against xyz_emb's
    leading shape. Gradients reach the embeddings, never the weights."""
    _check_options(spec, sigma_only, output_transient, need_dw)
    full = not sigma_only
    cd = spec.torch_dtype
    lead = xyz_emb.shape[:-1]
    emb = xyz_emb.reshape(-1, spec.emb_xyz).to(cd).contiguous()
    embd = None
    if full:
        embd = dir_emb.expand(*lead, spec.emb_dir).reshape(
            -1, spec.emb_dir).to(cd).contiguous()
    return _heads(spec, lead, *_Field.apply(False, packed, full, emb, embd))


def fused_field_apply(spec: FieldSpec, packed: PackedField,
                      pts: torch.Tensor, dirs: torch.Tensor | None,
                      sigma_only: bool = False, output_transient: bool = True,
                      need_dw: bool = False) -> dict:
    """Drop-in for NeRFHNFF on RAW inputs (the JAX package's
    fused_field_apply): pts (..., 3), dirs (..., 3) broadcastable against
    pts (unused when sigma_only). Returns the named heads in f32.
    Gradients reach pts and dirs, never the weights."""
    _check_options(spec, sigma_only, output_transient, need_dw)
    full = not sigma_only
    lead = pts.shape[:-1]
    x = pts.reshape(-1, 3).float().contiguous()
    d = (dirs.expand(*lead, 3).reshape(-1, 3).float().contiguous()
         if full else None)
    return _heads(spec, lead, *_Field.apply(True, packed, full, x, d))
