"""Measurement CLI of the port on one NVIDIA GPU: the counterpart of the
JAX package's runtime/probe.py commands kernelmicro, kernel and perf.

    python -m nefes_tpu_torch.runtime.probe kernelmicro [--tiles 512 2048 8192] [--out F]
    python -m nefes_tpu_torch.runtime.probe kernel [--sweep]
    python -m nefes_tpu_torch.runtime.probe perf [--refine_n 3]
    (each also takes --device cuda|cpu)

kernelmicro  ablations of the fused field at the fine-pass shape (N =
             614,400 rows): a bare bf16 8-layer chain per tile (K9), the
             chain with 2 and 4 sub-tiles interleaved (K10), the sin/cos
             embedding alone per tile (K11), square chains of width 128
             and 256 (K12); then the field kernel (K5) and the
             pre-embedded one forward (K1) and forward+backward (K1, K2).
             Each K9-K12 time is printed beside its plain version's, a
             bf16 torch.matmul chain's (cuBLAS, a yardstick only), its
             bound and its TFLOP/s
kernel       the field kernel K5 against the plain field in f32 and bf16,
             forward and forward+backward to the inputs; the
             composite-fused render (K7, K8) against the plain fine pass
             plus the compositor
perf         the pieces of a refinement iteration through the kernels of
             mode 3's main path (K1, K3, K4)

Inputs are random, from seeds. --device cuda (the default) times with CUDA
events; --device cpu runs the plain versions and times with the host
clock (no device number). Every time is the median of n calls after two
warm calls.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

H, W, FOCAL = 60, 80, 525.505 / 2 / 4      # 7-Scenes refinement geometry
NEAR, FAR = 0.0, 4.0
CHAIN_DEPTH, CHAIN_WIDTH, CHAIN_IN = 8, 128, 64

# --------------------------------------------------------------------------
# bounds: the least time an H100 could take for a function's work (the
# rules chip_smoke.py's kernels line uses too)
# --------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3


def bound(flops: float, ew_ops: float, nbytes: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the bf16 products at
    the tensor cores' peak plus the f32 elementwise work at the f32 peak,
    and the bytes (each input read once, each output written once) at the
    memory rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + ew_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tower_flops(spec, samples: int = 1) -> dict:
    """Matrix-product operations per sample (2 per multiply-add) that each
    field kernel's function needs. K1: the trunk and the sigma head.
    "full": the whole forward, with the dir layer and the 3+F rgb/feature
    head (the field kernels' full mode). K3: the forward to the dir layer
    per sample and the linear rgb/feature head once per ray of `samples`
    samples, on the ray's weighted sum of the dir layer's outputs (the
    composite's weights sum through it). The backwards recompute the
    forward without the head (K2), or with only the 3 rgb columns that the
    composite's weights need (K4), then backprop through the whole tower
    to the inputs, which takes as many products as the whole forward.
    K5-K8 do the products of K1 (sigma mode) or "full", K2, K3 and K4,
    plus the elementwise embedding (embed_ops). The
    training variants, transient mode: "fwd_t" the whole forward with the
    transient branch (t1 over final and the dir embedding, t2, t3, the 5
    heads); "bwd_dw_t" its recompute without the rgb head, the products
    back to the inputs, and one product per weight for dW, each as many
    as the whole forward."""
    E, Ed, Wd, Hd, C = (spec.emb_xyz, spec.emb_dir, spec.width, spec.half,
                        spec.rgbfeat)
    trunk = E * Wd + (spec.depth - 1) * Wd * Wd + Wd
    trunk += sum(E * Wd for i in spec.skips if 0 < i < spec.depth)
    body = trunk + Wd * Wd + (Wd + Ed) * Hd
    full = body + Hd * C
    trans = (Wd + Ed) * Hd + 2 * Hd * Hd + Hd * 5
    return {"K1": 2 * trunk, "K2": 2 * (body + full), "full": 2 * full,
            "K3": 2 * (body + Hd * C / samples),
            "K4": 2 * (body + Hd * 3 + full),
            "fwd_t": 2 * (full + trans),
            "bwd_dw_t": 2 * ((body + trans) + 2 * (full + trans))}


def embed_ops(nx: int, nd: int = 0) -> dict:
    """f32 elementwise operations per sample of a sin/cos embedding of nx
    bands of the point and nd of the direction, each sin or cos counted as
    one: forward 3 phases and 6 sin/cos per band and coordinate (the
    point only: "xyz_fwd"; point and direction: "fwd"); the chain rule
    back to the inputs, per band and coordinate 2 sin/cos, 3 products and
    2 sums ("bwd")."""
    return {"xyz_fwd": 3 * 3 * nx, "fwd": 3 * 3 * (nx + nd),
            "bwd": 3 * 7 * (nx + nd)}


def timeit(name: str, fn, n: int = 10, device="cuda") -> float:
    """Seconds per call of fn: two warm calls, then the median of n calls,
    each timed with CUDA events on a CUDA device and with the host clock
    on the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"{name}: {dt * 1e3:.3f} ms (median of {n})", flush=True)
    return dt


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(dev, seed: int, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=_gen(dev, seed), device=dev)


def _device_line(dev) -> str:
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions; no device time)")
    return f"device: {name}"


# --------------------------------------------------------------------------
# kernelmicro: where the fused field's time goes
# --------------------------------------------------------------------------

def micro_inputs(dev, n: int) -> dict:
    """The ablations' inputs at n rows, as the JAX probe makes them (its
    shapes and scales, torch generators): x (n, 64) ~ N(0, 1) and the
    chain's 8 weights ~ N(0, 1) · 0.05 (seeds 0 and 1..8), in bf16; pts
    (n, 3) ~ N(0, 1) f32 (seed 10); the square chains' inputs and weights,
    width 128 over n rows and width 256 over n / 2 (seeds 20 + i and 30,
    31)."""
    from nefes_tpu_torch.kernels.micro import pack_chain
    bf = torch.bfloat16
    D, Wd, E = CHAIN_DEPTH, CHAIN_WIDTH, CHAIN_IN

    def weights(width_in, width, seed0):
        return pack_chain((_randn(dev, seed0 + i, width_in if i == 0
                                  else width, width) * 0.05).to(bf)
                          for i in range(D))
    sq = {w_: (weights(w_, w_, 20), _randn(dev, 30 + k, n // (k + 1),
                                            w_).to(bf))
          for k, w_ in enumerate((128, 256))}
    return {"x": _randn(dev, 0, n, E).to(bf), "chain": weights(E, Wd, 1),
            "pts": _randn(dev, 10, n, 3), "sq": sq}


def _matmul_chain(cw, x):
    """Yardstick: the chain as bf16 torch.matmul calls (cuBLAS)."""
    h = x
    for w in cw.ws:
        h = torch.relu(h @ w)
    return h


def _chain_work(cw, rows: int) -> tuple:
    """(bf16 FLOPs, bytes: x read, out written, weights read once)."""
    flops = 2 * rows * (cw.E * cw.W + (cw.D - 1) * cw.W ** 2)
    return flops, 2 * (rows * (cw.E + cw.W) + cw.w.numel())


def cmd_kernelmicro(args) -> dict:
    """Returns {"results": the JAX command's keys (its full-kernel rows
    become the one full_kernel_tile64_ms: the port's field kernels have one
    tile of 64 rows), "kernels": per K9-K12 key its kernel, ms, plain_ms,
    library_ms, bound_ms, bound_by, tflops and blocks}."""
    from nefes_tpu_torch.fields.embedder import EmbedConfig, embed
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import micro as km
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel

    dev = torch.device(args.device)
    N = H * W * 128
    print(_device_line(dev), "N =", N, flush=True)
    ins = micro_inputs(dev, N)
    x_in, cw, pts = ins["x"], ins["chain"], ins["pts"]
    results, kernels = {}, {}

    def record(key, kernel, label, fn, plain, flops, nbytes, blocks,
               library=None, ew_ops=0):
        with torch.no_grad():
            ms = timeit(label, fn, device=dev) * 1e3
            plain_ms = timeit("  plain version", plain, device=dev) * 1e3
            lib_ms = (timeit("  bf16 torch.matmul chain", library,
                             device=dev) * 1e3 if library else None)
        bound_ms, bound_by = bound(flops, ew_ops, nbytes)
        row = {"kernel": kernel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": (flops + ew_ops) / ms / 1e9, "blocks": blocks}
        results[key], kernels[key] = ms, row
        print(f"  {kernel}: {ms:.3f} ms over {blocks} blocks, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({(flops + ew_ops) / 1e9:.1f} G ops, {nbytes / 1e6:.1f} MB; "
              f"{row['tflops']:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
              f"cuBLAS chain "
              f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}", flush=True)

    flops, nbytes = _chain_work(cw, N)
    for tile in args.tiles:
        record(f"chain8_tile{tile}_ms", "K9 chain",
               f"bare 8-layer chain tile={tile}",
               lambda tile=tile: km.chain(cw, x_in, tile),
               lambda: km.chain_plain(cw, x_in), flops, nbytes, N // tile,
               lambda: _matmul_chain(cw, x_in))
    for nb in (2, 4):
        record(f"chain8_interleave{nb}_ms", "K10 chain_interleaved",
               f"interleaved x{nb} chain tile=2048",
               lambda nb=nb: km.chain_interleaved(cw, x_in, 2048, nb),
               lambda: km.chain_plain(cw, x_in), flops, nbytes, N // 2048,
               lambda: _matmul_chain(cw, x_in))

    # every tile: the JAX probe's cap at 2048 is a TPU VMEM limit
    emb_ops = N * embed_ops(km.EMBED_BANDS)["xyz_fwd"]
    for tile in args.tiles:
        record(f"embed_tile{tile}_ms", "K11 embed_micro",
               f"embed-only kernel tile={tile}",
               lambda tile=tile: km.embed_micro(pts, tile),
               lambda: km.embed_micro_plain(pts), 0,
               N * (3 * 4 + km.EMBED_COLS * 2), N // tile, ew_ops=emb_ops)

    times = {}
    for w_, label, tile in ((128, "square chain8 w=128 rows=N", 2048),
                            (256, "square chain8 w=256 rows=N/2 "
                                  "(block-diag equiv)", 512)):
        scw, sx = ins["sq"][w_]
        key = ("sq_chain8_w128_ms" if w_ == 128
               else "sq_chain8_w256_halfrows_ms")
        record(key, "K12 chain_sq", label,
               lambda scw=scw, sx=sx, tile=tile: km.chain_sq(scw, sx, tile),
               lambda scw=scw, sx=sx: km.chain_plain(scw, sx),
               *_chain_work(scw, sx.shape[0]), sx.shape[0] // tile,
               lambda scw=scw, sx=sx: _matmul_chain(scw, sx))
        times[w_] = results[key] / 1e3
    fl128 = 2 * N * 128 * 128 * CHAIN_DEPTH
    results["sq_chain8_w128_tflops"] = round(fl128 / times[128] / 1e12, 1)
    results["sq_chain8_w256_raw_tflops"] = round(
        2 * fl128 / times[256] / 1e12, 1)
    results["blockdiag_packing_wins"] = bool(times[256] < times[128])

    # the production field kernels at the same shapes
    cfg16 = ModelConfig(dtype=torch.bfloat16)
    model = NeFeSModel(cfg16, device=dev,
                       generator=torch.Generator().manual_seed(0))
    dirs = _randn(dev, 9, N, 3)
    with torch.no_grad():
        _, pf = model.pack_fused()
        results["full_kernel_tile64_ms"] = timeit(
            "full field kernel (K5) tile=64",
            lambda: kf.field_fwd(pf, kf.FULL, pts, dirs), device=dev) * 1e3
        xe = embed(pts, EmbedConfig(num_freqs=10)).to(torch.bfloat16)
        de = embed(dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True),
                   EmbedConfig(num_freqs=4)).to(torch.bfloat16)
        results["pre_kernel_fwd_ms"] = timeit(
            "pre-embedded field kernel fwd (K1)",
            lambda: kf.field_fwd_pre(pf, kf.FULL, xe, de), device=dev) * 1e3
        # the cotangent of the sum of every head: ones
        ones = [torch.ones(s, dtype=torch.bfloat16, device=dev)
                for s in ((N,), (N, 3), (N, pf.spec.feature_dim))]
        results["pre_kernel_fwdbwd_ms"] = timeit(
            "pre-embedded field kernel fwd+bwd (K1, K2)",
            lambda: (kf.field_fwd_pre(pf, kf.FULL, xe, de),
                     kf.field_bwd_pre(pf, kf.FULL, xe, de, *ones)),
            device=dev) * 1e3
    # the field kernels' rate, to set beside the bare chain's (K9)
    fl = tower_flops(pf.spec)
    for key, per_row in (("full_kernel_tile64_ms", fl["full"]),
                         ("pre_kernel_fwd_ms", fl["full"]),
                         ("pre_kernel_fwdbwd_ms", fl["full"] + fl["K2"])):
        print(f"  {key}: {N * per_row / 1e9:.1f} GFLOP bf16, "
              f"{N * per_row / results[key] / 1e9:.2f} TFLOP/s", flush=True)

    print(json.dumps(results), flush=True)
    out = {"results": results, "kernels": kernels}
    if args.out:
        with open(args.out, "w") as fo:
            json.dump(out, fo, indent=1)
    return out


# --------------------------------------------------------------------------
# kernel: the field kernel and the fused render against the plain path
# --------------------------------------------------------------------------

def _sum_heads(o: dict):
    return (o["static_rgb"].float().sum() + o["static_sigma"].float().sum()
            + 1e-3 * o["static_feat"].float().sum())


def cmd_kernel(args) -> dict:
    """Three-way parity of the fine field at N = H·W·128 samples (plain
    f32, plain bf16, K5 bf16, against plain f32) and times; the
    composite-fused render (K7 forward, K8 backward) against the plain
    fine pass plus the compositor at H·W rays x 128 samples. Returns the
    times (ms), the max-abs errors and fused_render_rgb_maxerr."""
    from nefes_tpu_torch.fields.embedder import embed
    from nefes_tpu_torch.kernels.fused_field import fused_field_apply
    from nefes_tpu_torch.kernels.fused_render import fused_render_apply
    from nefes_tpu_torch.render.compositor import composite
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel

    dev = torch.device(args.device)
    N = H * W * 128     # fine pass of one H/4 7-Scenes render
    print(_device_line(dev), "N =", N, flush=True)
    models = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        models[name] = NeFeSModel(ModelConfig(dtype=dt), device=dev,
                                  generator=torch.Generator().manual_seed(0))
        models[name].requires_grad_(False)
    m16 = models["bf16"]
    cfg = m16.cfg
    spec = m16.fused_spec("fine")
    with torch.no_grad():
        _, pf = m16.pack_fused()
    pts, dirs = _randn(dev, 1, N, 3), _randn(dev, 2, N, 3)

    def plain(m, x, d):
        return m.fine_fn(embed(x, cfg.xyz_embed), embed(d, cfg.dir_embed),
                         False, False)

    def kern(x, d):
        return fused_field_apply(spec, pf, x, d, sigma_only=False,
                                 output_transient=False)

    results = {}
    with torch.no_grad():
        o32, o16, ok = (plain(models["f32"], pts, dirs),
                        plain(m16, pts, dirs), kern(pts, dirs))
        for key in ("static_sigma", "static_rgb", "static_feat"):
            a = o32[key].float()
            e_plain = (o16[key].float() - a).abs().max().item()
            e_kern = (ok[key].float() - a).abs().max().item()
            results[f"{key}_maxerr_plain16"] = e_plain
            results[f"{key}_maxerr_kern16"] = e_kern
            print(f"{key}: |plain16-f32|max={e_plain:.4g} "
                  f"|kern16-f32|max={e_kern:.4g}", flush=True)
        del o32, o16, ok
        results["plain_fwd_ms"] = timeit(
            "plain bf16 fwd", lambda: plain(m16, pts, dirs),
            device=dev) * 1e3
        results["kern_fwd_ms"] = timeit(
            "kernel fwd (K5)", lambda: kern(pts, dirs), device=dev) * 1e3

    def grad_pts(f):
        x = pts.detach().requires_grad_(True)
        return torch.autograd.grad(_sum_heads(f(x, dirs)), x)[0]

    results["plain_fwdbwd_ms"] = timeit(
        "plain bf16 fwd+bwd(dx)", lambda: grad_pts(
            lambda x, d: plain(m16, x, d)), device=dev) * 1e3
    results["kern_fwdbwd_ms"] = timeit(
        "kernel fwd+bwd(dx) (K5, K6)", lambda: grad_pts(kern),
        device=dev) * 1e3
    if args.sweep:
        # the port's field forward has one tile (in full mode the warp
        # path's block tile of 128 samples): the sweep's one row is the
        # forward timed above
        results["kern_fwd_tile64_ms"] = results["kern_fwd_ms"]

    R, S = H * W, 128
    rays_o = _randn(dev, 3, R, 3) * 0.1
    rays_d = _randn(dev, 4, R, 3) + torch.tensor([0.0, 0.0, -1.0],
                                                   device=dev)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    z = torch.sort(torch.rand((R, S), generator=_gen(dev, 3), device=dev)
                   * 3.7 + 0.3, dim=-1).values
    pts3 = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    def unfused(p3, vd, zz):
        xe = embed(p3, cfg.xyz_embed)
        de = embed(vd[:, None, :].expand(p3.shape), cfg.dir_embed)
        raw = m16.fine_fn(xe, de, False, False)
        return composite(raw, zz, output_transient=False, test_time=True)

    def fused(p3, vd, zz):
        return fused_render_apply(spec, pf, p3, vd, zz)

    with torch.no_grad():
        results["unfused_fine_composite_fwd_ms"] = timeit(
            "unfused fine+composite fwd",
            lambda: unfused(pts3, viewdirs, z)["rgb"], device=dev) * 1e3
        results["fused_render_fwd_ms"] = timeit(
            "fused render fwd (K7)", lambda: fused(pts3, viewdirs, z)["rgb"],
            device=dev) * 1e3

    def grads(f):
        p3 = pts3.detach().requires_grad_(True)
        zz = z.detach().requires_grad_(True)
        o = f(p3, viewdirs, zz)
        loss = o["rgb"].float().sum() + 1e-3 * o["feat"].float().sum()
        return torch.autograd.grad(loss, (p3, zz))

    results["unfused_fine_composite_fwdbwd_ms"] = timeit(
        "unfused fine+composite fwd+bwd", lambda: grads(unfused),
        device=dev) * 1e3
    results["fused_render_fwdbwd_ms"] = timeit(
        "fused render fwd+bwd (K7, K8)", lambda: grads(fused),
        device=dev) * 1e3
    with torch.no_grad():
        a = unfused(pts3, viewdirs, z)["rgb"].float()
        b = fused(pts3, viewdirs, z)["rgb"].float()
        results["fused_render_rgb_maxerr"] = (a - b).abs().max().item()
    print(json.dumps(results), flush=True)
    return results


# --------------------------------------------------------------------------
# perf: the pieces of a refinement iteration
# --------------------------------------------------------------------------

def main_path_config(cfg):
    """Mode 3's main path: 64 + 64 samples at test time, the frozen field
    through the pre-embedded kernels, the fine pass composite-fused (K1,
    K3, K4)."""
    return cfg.render_config(n_samples=64, n_importance=64,
                             output_transient=False, test_time=True,
                             perturb=False, remat=False, fused=True,
                             fused_pre=True, fused_render=True,
                             fused_need_dw=False)


def cmd_perf(args) -> dict:
    """Times (ms) of: the forward render_feature_image, its pose gradient,
    render_image alone, a 50-iteration refine_pose_single (args.refine_n
    calls), embed + the plain fine MLP over H·W·128 samples, sample_pdf
    over H·W rays and the composite of H·W x 128 samples with 131
    channels."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    from nefes_tpu_torch.fields.embedder import embed
    from nefes_tpu_torch.refine import (
        RefineConfig, refine_pose_single, render_feature_image,
    )
    from nefes_tpu_torch.refine.losses import feature_cosine_loss
    from nefes_tpu_torch.render.compositor import composite
    from nefes_tpu_torch.render.renderer import render_image
    from nefes_tpu_torch.render.sampling import sample_pdf, stratified_samples
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel

    dev = torch.device(args.device)
    print(_device_line(dev), flush=True)
    cfg = ModelConfig(dtype=torch.bfloat16)
    model = NeFeSModel(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    rcfg = main_path_config(cfg)
    with torch.no_grad():
        packed = model.pack_fused()
    pose = torch.from_numpy(look_at_pose(
        np.array([0.0, 0.3, 2.4], np.float32))).to(dev)
    hist = torch.zeros(10, device=dev)
    hwf = (H, W, FOCAL)
    target = torch.zeros((H, W, cfg.feature_dim), device=dev)

    def moved(sh):
        """pose with sh (3,) added to its translation."""
        return pose + torch.nn.functional.pad(sh[:, None], (3, 0))

    zero = torch.zeros(3, device=dev)
    results = {}
    with torch.no_grad():
        results["render_feature_image_fwd_ms"] = timeit(
            "forward render_feature_image", lambda: render_feature_image(
                model, moved(zero), hist, hwf, NEAR, FAR, rcfg,
                packed=packed), device=dev) * 1e3

    def pose_grad():
        sh = zero.clone().requires_grad_(True)
        _, fused = render_feature_image(model, moved(sh), hist, hwf, NEAR,
                                        FAR, rcfg, packed=packed)
        return torch.autograd.grad(feature_cosine_loss(fused, target), sh)

    results["pose_grad_fwdbwd_ms"] = timeit(
        "fwd+bwd (pose grad)", pose_grad, device=dev) * 1e3
    coarse, fine = model.field_fns(rcfg, packed)
    with torch.no_grad():
        results["render_only_fwd_ms"] = timeit(
            "render only fwd", lambda: render_image(
                coarse, fine, H, W, FOCAL, moved(zero), NEAR, FAR, rcfg),
            device=dev) * 1e3
    ws_vec = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    rfc = RefineConfig(opt_iter=50, lr_r=0.0087, lr_t=0.01)
    results["refine50_ms"] = timeit(
        "50-iter refine", lambda: refine_pose_single(
            model, pose, target, hist, ws_vec, hwf, NEAR, FAR, rcfg, rfc),
        n=args.refine_n, device=dev) * 1e3

    R, n_fine = H * W, H * W * 128
    xyz_f, dir_f = _randn(dev, 1, n_fine, 3), _randn(dev, 2, n_fine, 3)
    z = stratified_samples(None, R, 64, 0.0, 4.0, perturb=False, device=dev)
    wgt = torch.rand((R, 64), generator=_gen(dev, 1), device=dev)
    zs = torch.sort(torch.cat([z, z + 0.01], -1), -1).values
    raw = {"static_rgb": torch.rand((R, 128, 3), generator=_gen(dev, 2),
                                    device=dev),
           "static_feat": _randn(dev, 3, R, 128, 128),
           "static_sigma": torch.rand((R, 128), generator=_gen(dev, 4),
                                      device=dev)}
    with torch.no_grad():
        results["embed_fine_mlp_ms"] = timeit(
            f"embed+fine MLP {n_fine}", lambda: model.fine_fn(
                embed(xyz_f, cfg.xyz_embed), embed(dir_f, cfg.dir_embed),
                False, False), device=dev) * 1e3
        results["sample_pdf_ms"] = timeit(
            "sample_pdf RxS->64", lambda: sample_pdf(
                None, 0.5 * (z[..., 1:] + z[..., :-1]), wgt[..., 1:-1], 64,
                det=True), device=dev) * 1e3
        results["composite_ms"] = timeit(
            "composite Rx128 (131ch)", lambda: composite(raw, zs)["rgb"],
            device=dev) * 1e3
    print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (the plain versions)")
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("kernelmicro", parents=[common])
    pm.add_argument("--tiles", type=int, nargs="+", default=[512, 2048, 8192])
    pm.add_argument("--out", default="")
    pk = sub.add_parser("kernel", parents=[common])
    pk.add_argument("--sweep", action="store_true")
    pp = sub.add_parser("perf", parents=[common])
    pp.add_argument("--refine_n", type=int, default=3,
                    help="timed calls of the 50-iteration refine")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        p.error("no CUDA device; --device cpu runs the plain versions")
    {"kernelmicro": cmd_kernelmicro, "kernel": cmd_kernel,
     "perf": cmd_perf}[args.cmd](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
