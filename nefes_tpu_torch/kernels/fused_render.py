"""Composite-fused fine render: the fine tower, its heads and the volume
composite in one pass emitting per-ray outputs, as hand-written Hopper
kernels (csrc/fused_render.cu) with a plain PyTorch version of each, on
pre-embedded inputs (K3, K4) or on raw points and directions (K7, K8).

  K3 render_fwd_pre  replaces nefes_tpu/kernels/fused_render.py:
                     make_fused_render_pre.run_fwd (_render_fwd_kernel_pre)
  K4 render_bwd_pre  replaces run_bwd (_render_bwd_kernel_pre): the
                     frozen-field recompute backward giving d_emb, d_embd
                     and d_z
  K7 render_fwd      replaces make_fused_render.run_fwd
                     (_render_fwd_kernel): K3 embedding in the kernel
  K8 render_bwd      replaces make_fused_render.run_bwd
                     (_render_bwd_kernel): K4 ending in d_pts, d_dirs per
                     sample (f32) and d_z

The composite is the refinement fine pass of the compositor: deltas with
a 1e2 tail, alpha = 1 - exp(-delta·sigma), transmittance exp of the
exclusive cumsum of log(max(1 - alpha, 1e-10)), no noise, no transient
heads. Output per ray: [rgb (3) | features (F) | depth | acc], f32. In the
backward the feature channels never reach the weights' cotangent (the
stop-gradient rule of the compositor): only rgb, depth and acc do. The
kernels take any number of samples per ray: the forward keeps one block
tile of state, and the backward keeps its per-sample state in a global
scratch (bwd_scratch) past what a block's shared memory holds.
"""

from __future__ import annotations

import torch

from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels.fused_field import (
    _DTYPE_CODE, FieldSpec, PackedField, _embed_raw, _ptr, _softplus,
    _stream, check, check_packed, dims, embed_backward_plain, raise_on,
    tower_backward_plain, tower_plain,
)

DELTA_INF = 1e2
_LOG_EPS = 1e-10


def _composite_pieces(sigma: torch.Tensor, z: torch.Tensor):
    """sigma (R, S) post-softplus f32, z (R, S) -> (alpha, trans, weights,
    deltas), all (R, S) f32, with log-space transmittance."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full_like(z[:, :1], DELTA_INF)], dim=1)
    alpha = 1.0 - torch.exp(-deltas * sigma)
    log1ma = torch.log(torch.clamp_min(1.0 - alpha, _LOG_EPS))
    log_t = torch.cat([torch.zeros_like(log1ma[:, :1]),
                       torch.cumsum(log1ma, dim=1)[:, :-1]], dim=1)
    trans = torch.exp(log_t)
    return alpha, trans, alpha * trans, deltas


def render_fwd_pre_plain(p: PackedField, emb, embd, z):
    """K3's function: emb (R·S, E), embd (R·S, Ed) in the pack dtype, z
    (R, S) f32 -> (R, 3 + F + 2) f32."""
    R, S = z.shape
    zs, rf, _ = tower_plain(p, True, emb, embd)
    sigma = _softplus(zs).reshape(R, S)
    _, _, wgt, _ = _composite_pieces(sigma, z)
    ray = torch.einsum("rs,rsc->rc", wgt, rf.reshape(R, S, -1))
    return torch.cat([ray, (wgt * z).sum(1, keepdim=True),
                      wgt.sum(1, keepdim=True)], dim=1)


def _render_bwd_plain(p: PackedField, emb, embd, z, g):
    """Recompute the fine pass and backprop the per-ray cotangent g
    (R, 3 + F + 2) f32 -> (d_emb, d_embd, d_z (R, S)), all f32."""
    R, S = z.shape
    C = p.spec.rgbfeat
    zs, rf, acts = tower_plain(p, True, emb, embd)
    sigma = _softplus(zs).reshape(R, S)
    alpha, trans, wgt, deltas = _composite_pieces(sigma, z)
    g_ray, g_depth, g_acc = g[:, :C], g[:, C:C + 1], g[:, C + 1:C + 2]

    d_rgbfeat = (wgt[:, :, None] * g_ray[:, None, :]).reshape(R * S, C)
    # stop-gradient rule: only rgb (and depth, acc) feed the weights
    rgb_dot = (rf[:, :3].reshape(R, S, 3) * g_ray[:, None, :3]).sum(-1)
    d_w = rgb_dot + z * g_depth + g_acc
    dww = d_w * wgt
    suffix_incl = torch.flip(torch.cumsum(torch.flip(dww, [1]), 1), [1])
    suffix = torch.cat([suffix_incl[:, 1:], torch.zeros_like(dww[:, :1])],
                       dim=1)                            # sum over k > i
    d_alpha = d_w * trans - suffix / torch.clamp_min(1.0 - alpha, _LOG_EPS)
    exp_term = torch.exp(-deltas * sigma)
    d_sigma = d_alpha * deltas * exp_term
    d_delta = d_alpha * sigma * exp_term
    # the last delta is the constant tail: no z cotangent
    d_delta = torch.cat([d_delta[:, :-1], torch.zeros_like(d_delta[:, :1])],
                        dim=1)
    d_shift = torch.cat([torch.zeros_like(d_delta[:, :1]), d_delta[:, :-1]],
                        dim=1)
    d_z = wgt * g_depth + d_shift - d_delta
    d_emb, d_embd, _ = tower_backward_plain(p, True, acts,
                                            d_sigma.reshape(-1), d_rgbfeat)
    return d_emb, d_embd, d_z


def render_bwd_pre_plain(p: PackedField, emb, embd, z, g):
    """K4's function: recompute the fine pass and backprop the per-ray
    cotangent g (R, 3 + F + 2) f32 -> (d_emb, d_embd) in the pack dtype
    and d_z (R, S) f32."""
    cd = p.spec.torch_dtype
    d_emb, d_embd, d_z = _render_bwd_plain(p, emb, embd, z, g)
    return d_emb.to(cd), d_embd.to(cd), d_z


def render_fwd_plain(p: PackedField, pts, dirs, z):
    """K7's function: pts, dirs (R·S, 3) f32 (dirs per sample), z (R, S)
    f32 -> (R, 3 + F + 2) f32."""
    return render_fwd_pre_plain(p, *_embed_raw(p, True, pts, dirs), z)


def render_bwd_plain(p: PackedField, pts, dirs, z, g):
    """K8's function: (d_pts, d_dirs) (R·S, 3) and d_z (R, S), all f32."""
    spec = p.spec
    d_emb, d_embd, d_z = _render_bwd_plain(
        p, *_embed_raw(p, True, pts, dirs), z, g)
    return (embed_backward_plain(d_emb, pts, spec.n_freqs_xyz),
            embed_backward_plain(d_embd, dirs, spec.n_freqs_dir), d_z)


def _check_render(p: PackedField, x, dirs, z, raw: bool) -> None:
    spec, dev, cd = p.spec, x.device, p.spec.torch_dtype
    R, S = z.shape
    check_packed(p, dev)
    if raw:
        check(x, "pts", (R * S, 3), torch.float32, dev)
        check(dirs, "dirs", (R * S, 3), torch.float32, dev)
    else:
        check(x, "emb", (R * S, spec.emb_xyz), cd, dev)
        check(dirs, "embd", (R * S, spec.emb_dir), cd, dev)
    check(z, "z", (R, S), torch.float32, dev)


def bwd_scratch(lib, p: PackedField, R: int, S: int, device):
    """The render backward's global scratch for R rays of S samples: None
    while a block keeps the per-sample state in shared memory (at the
    full-width tower up to 269 samples in bf16, 204 in f32), else one
    slice a ray from the caching allocator."""
    n = lib.nefes_render_bwd_scratch_bytes(_DTYPE_CODE[p.spec.torch_dtype], S,
                                           *dims(p.spec))
    return torch.empty(R * n, dtype=torch.uint8, device=device) if n else None


def render_fwd_pre(p: PackedField, emb, embd, z):
    """K3: (R, 3 + F + 2) per-ray outputs. The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if emb.device.type == "cpu":
        return render_fwd_pre_plain(p, emb, embd, z)
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for device {emb.device}")
    _check_render(p, emb, embd, z, False)
    lib = build.library("fused_render")
    R, S = z.shape
    out = torch.empty((R, p.spec.rgbfeat + 2), dtype=torch.float32,
                      device=emb.device)
    err = lib.nefes_render_fwd_pre(
        _DTYPE_CODE[p.spec.torch_dtype], R, S, emb.data_ptr(),
        embd.data_ptr(), z.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
        *dims(p.spec), out.data_ptr(), _stream())
    render_fwd_pre.launches += 1
    raise_on(err, "render_fwd_pre")
    return out


def render_bwd_pre(p: PackedField, emb, embd, z, g):
    """K4: (d_emb, d_embd) in the pack dtype and d_z (R, S) f32."""
    if emb.device.type == "cpu":
        return render_bwd_pre_plain(p, emb, embd, z, g)
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for device {emb.device}")
    _check_render(p, emb, embd, z, False)
    lib = build.library("fused_render")
    R, S = z.shape
    spec, dev, cd = p.spec, emb.device, p.spec.torch_dtype
    check(g, "g", (R, spec.rgbfeat + 2), torch.float32, dev)
    scratch = bwd_scratch(lib, p, R, S, dev)
    d_emb = torch.empty((R * S, spec.emb_xyz), dtype=cd, device=dev)
    d_embd = torch.empty((R * S, spec.emb_dir), dtype=cd, device=dev)
    d_z = torch.empty((R, S), dtype=torch.float32, device=dev)
    err = lib.nefes_render_bwd_pre(
        _DTYPE_CODE[cd], R, S, emb.data_ptr(), embd.data_ptr(),
        z.data_ptr(), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
        *dims(spec), g.data_ptr(), d_emb.data_ptr(), d_embd.data_ptr(),
        d_z.data_ptr(), _ptr(scratch), _stream())
    render_bwd_pre.launches += 1
    raise_on(err, "render_bwd_pre")
    return d_emb, d_embd, d_z


def render_fwd(p: PackedField, pts, dirs, z):
    """K7: (R, 3 + F + 2) per-ray outputs from raw pts, dirs (R·S, 3) f32.
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if pts.device.type == "cpu":
        return render_fwd_plain(p, pts, dirs, z)
    if pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {pts.device}")
    _check_render(p, pts, dirs, z, True)
    lib = build.library("fused_render")
    R, S = z.shape
    out = torch.empty((R, p.spec.rgbfeat + 2), dtype=torch.float32,
                      device=pts.device)
    err = lib.nefes_render_fwd_raw(
        _DTYPE_CODE[p.spec.torch_dtype], R, S, pts.data_ptr(),
        dirs.data_ptr(), z.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
        *dims(p.spec), out.data_ptr(), _stream())
    render_fwd.launches += 1
    raise_on(err, "render_fwd")
    return out


def render_bwd(p: PackedField, pts, dirs, z, g):
    """K8: (d_pts, d_dirs) (R·S, 3) and d_z (R, S), all f32."""
    if pts.device.type == "cpu":
        return render_bwd_plain(p, pts, dirs, z, g)
    if pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {pts.device}")
    _check_render(p, pts, dirs, z, True)
    lib = build.library("fused_render")
    R, S = z.shape
    spec, dev, f32 = p.spec, pts.device, torch.float32
    check(g, "g", (R, spec.rgbfeat + 2), f32, dev)
    scratch = bwd_scratch(lib, p, R, S, dev)
    d_pts = torch.empty((R * S, 3), dtype=f32, device=dev)
    d_dirs = torch.empty((R * S, 3), dtype=f32, device=dev)
    d_z = torch.empty((R, S), dtype=f32, device=dev)
    err = lib.nefes_render_bwd_raw(
        _DTYPE_CODE[spec.torch_dtype], R, S, pts.data_ptr(), dirs.data_ptr(),
        z.data_ptr(), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
        *dims(spec), g.data_ptr(), d_pts.data_ptr(), d_dirs.data_ptr(),
        d_z.data_ptr(), _ptr(scratch), _stream())
    render_bwd.launches += 1
    raise_on(err, "render_bwd")
    return d_pts, d_dirs, d_z


for _k in (render_fwd_pre, render_bwd_pre, render_fwd, render_bwd):
    _k.launches = 0


class _Render(torch.autograd.Function):
    """Frozen-field fine pass + composite: differentiable in its inputs
    (the embeddings, or raw the points and directions) and z; the weights
    get no cotangent."""

    @staticmethod
    def forward(ctx, raw, p, x, dirs, z):
        ctx.raw, ctx.p = raw, p
        ctx.save_for_backward(x, dirs, z)
        return (render_fwd if raw else render_fwd_pre)(p, x, dirs, z)

    @staticmethod
    def backward(ctx, g):
        x, dirs, z = ctx.saved_tensors
        bwd = render_bwd if ctx.raw else render_bwd_pre
        d_x, d_dirs, d_z = bwd(ctx.p, x, dirs, z, g.float().contiguous())
        return None, None, d_x, d_dirs, d_z


def _per_ray(spec: FieldSpec, out: torch.Tensor) -> dict:
    C = spec.rgbfeat
    depth, acc = out[:, C], out[:, C + 1]
    # the compositor's formula
    disp = 1.0 / torch.clamp_min(depth / acc, 1e-10)
    return {"rgb": out[:, :3], "feat": out[:, 3:C], "depth": depth,
            "acc": acc, "disp": disp}


def fused_render_apply_pre(spec: FieldSpec, packed: PackedField,
                           xyz_emb: torch.Tensor, dir_emb: torch.Tensor,
                           z_vals: torch.Tensor) -> dict:
    """Composite-fused fine render on pre-embedded inputs. xyz_emb
    (R, S, E), dir_emb (R, S, Ed) (or broadcastable), z_vals (R, S).
    Returns {rgb (R, 3), feat (R, F), depth (R,), acc (R,), disp (R,)}."""
    R, S, E = xyz_emb.shape
    cd = spec.torch_dtype
    emb = xyz_emb.reshape(R * S, E).to(cd).contiguous()
    embd = dir_emb.expand(R, S, spec.emb_dir).reshape(
        R * S, spec.emb_dir).to(cd).contiguous()
    return _per_ray(spec, _Render.apply(False, packed, emb, embd,
                                        z_vals.float().contiguous()))


def fused_render_apply(spec: FieldSpec, packed: PackedField,
                       pts: torch.Tensor, viewdirs: torch.Tensor,
                       z_vals: torch.Tensor) -> dict:
    """Composite-fused fine render on RAW inputs (the JAX package's
    fused_render_apply). pts (R, S, 3), viewdirs (R, 3), z_vals (R, S).
    The kernels take a direction per sample; autograd of the broadcast
    sums d_dirs over S into the per-ray viewdirs. Returns {rgb (R, 3),
    feat (R, F), depth (R,), acc (R,), disp (R,)}."""
    R, S, _ = pts.shape
    x = pts.reshape(R * S, 3).float().contiguous()
    dirs = viewdirs.float()[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    return _per_ray(spec, _Render.apply(True, packed, x, dirs.contiguous(),
                                        z_vals.float().contiguous()))
