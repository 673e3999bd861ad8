"""Measurement CLI of the port on one NVIDIA GPU: the counterpart of the
JAX package's runtime/probe.py commands kernelmicro, kernel, perf, mode2,
accuracy, inscan_ab, profile and golden.

    python -m nefes_tpu_torch.runtime.probe kernelmicro [--tiles 512 2048 8192] [--out F]
    python -m nefes_tpu_torch.runtime.probe kernel [--sweep]
    python -m nefes_tpu_torch.runtime.probe perf [--refine_n 3]
    python -m nefes_tpu_torch.runtime.probe mode2 [--iters 50]
    python -m nefes_tpu_torch.runtime.probe accuracy [--cache F] [--out F]
    python -m nefes_tpu_torch.runtime.probe inscan_ab [--out F]
    python -m nefes_tpu_torch.runtime.probe profile [--mode {2,3,both}] [--out F]
    python -m nefes_tpu_torch.runtime.probe golden --tar T --apr P \
        --scene S --datadir D --data_root R --ref REF [--tol_t ...]
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
mode2        mode-2 refinement with DFNet in f32 against bf16, in turns,
             through mode 2's kernels (K5, K7, K8): s/frame and the final
             loss of each
accuracy     the whole pipeline on a synthetic scene: three-stage field
             training (K5, K6 +dW, dW), a contrastively finetuned DFNet,
             a DFNet APR, then mode 2 with the verification fail-safe
             (K5, K7, K8) and mode 3 (K1, K3, K4) in f32, and the pose
             accuracy they reach (the JAX command's JSON; the pieces are
             runtime/accuracy.py)
inscan_ab    s/frame of the 50-iteration refinement in mode 3 and mode 2
             (bf16 DFNet) for each kernel-integration variant: unfused
             (plain PyTorch), fused_raw (K5, K6), fused_pre (K1, K2) and
             render_pre (K1, K3, K4), render_pre through the captured
             loop on the card, the others eager
profile      torch.profiler over captured refinement frames of the refine
             CLI's kernel paths (mode 3 K1, K3, K4; mode 2 K5, K7, K8):
             device time by framework phase (runtime/xprof.py), the host
             gap, each phase's bytes against the memory rate, the longest
             kernels; writes PROFILE_torch.json
golden       the paper-parity run: a reference NeFeS .tar and DFNet .pt
             through the refine CLI in mode 2, its medians against the
             paper_result txts; exits non-zero past the tolerances

Inputs (and accuracy's scene and weights) are random, from seeds.
--device cuda (the default) times with CUDA events; --device cpu runs the
plain versions and times with the host clock (no device number). Every
time is the median of n calls after two warm calls.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

H, W, FOCAL = 60, 80, 525.505 / 2 / 4      # 7-Scenes refinement geometry
NEAR, FAR = 0.0, 4.0
ITERS = 50          # refinement iterations a frame (inscan_ab, profile)
CHAIN_DEPTH, CHAIN_WIDTH, CHAIN_IN = 8, 128, 64
# the paper architecture, which perf and accuracy build (ModelConfig's
# fields; the CPU tests swap in a smaller one)
ARCH = dict(depth=8, width=128, feature_dim=128)

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


def timeit(name: str, fn, n: int = 10, device="cuda", warm: int = 2
           ) -> float:
    """Seconds per call of fn: `warm` warm calls, then the median of n
    calls, each timed with CUDA events on a CUDA device and with the host
    clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warm):
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


# kernelmicro's launches between a timing's two CUDA events: the host
# enqueues the next while the card runs one, so a sub-millisecond time is
# the kernel's and not also its wrapper's host work
MICRO_CALLS = 10


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
    library_ms, bound_ms, bound_by, tflops, units (N / tile) and blocks
    (the CTAs the kernel's persistent grid launches on the card; None on
    the CPU, which launches none)}."""
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

    cuda = dev.type == "cuda"
    calls = MICRO_CALLS if cuda else 1

    def per_call(label, f):
        return timeit(f"{label} ({calls} calls a timing)",
                      lambda: [f() for _ in range(calls)],
                      device=dev) * 1e3 / calls

    def record(key, kernel, label, fn, plain, flops, nbytes, units, grid,
               library=None, ew_ops=0):
        with torch.no_grad():
            ms = per_call(label, fn)
            plain_ms = per_call("  plain version", plain)
            lib_ms = (per_call("  bf16 torch.matmul chain", library)
                      if library else None)
        bound_ms, bound_by = bound(flops, ew_ops, nbytes)
        blocks = grid() if cuda else None
        row = {"kernel": kernel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": (flops + ew_ops) / ms / 1e9,
               "units": units, "blocks": blocks}
        results[key], kernels[key] = ms, row
        print(f"  {kernel}: {ms:.3f} ms, {units} units over {blocks} "
              f"CTAs, bound "
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
               lambda tile=tile: km.chain_grid(cw, N, tile),
               lambda: _matmul_chain(cw, x_in))
    for nb in (2, 4):
        record(f"chain8_interleave{nb}_ms", "K10 chain_interleaved",
               f"interleaved x{nb} chain tile=2048",
               lambda nb=nb: km.chain_interleaved(cw, x_in, 2048, nb),
               lambda: km.chain_plain(cw, x_in), flops, nbytes, N // 2048,
               lambda nb=nb: km.chain_grid(cw, N, 2048, nb),
               lambda: _matmul_chain(cw, x_in))

    # every tile: the JAX probe's cap at 2048 is a TPU VMEM limit
    emb_ops = N * embed_ops(km.EMBED_BANDS)["xyz_fwd"]
    for tile in args.tiles:
        record(f"embed_tile{tile}_ms", "K11 embed_micro",
               f"embed-only kernel tile={tile}",
               lambda tile=tile: km.embed_micro(pts, tile),
               lambda: km.embed_micro_plain(pts), 0,
               N * (3 * 4 + km.EMBED_COLS * 2), N // tile,
               lambda tile=tile: km.embed_grid(N, tile)[0], ew_ops=emb_ops)

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
               lambda scw=scw, sx=sx, tile=tile: km.chain_grid(
                   scw, sx.shape[0], tile),
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
    cfg = ModelConfig(**ARCH, dtype=torch.bfloat16)
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


def cmd_mode2(args) -> dict:
    """Mode-2 refinement with DFNet (the APR and the feature extractor)
    in f32 against bf16 (the JAX probe's mode2 command; the parameters
    stay f32): refine_apr_single of args.iters iterations on a 4H x 4W
    query (random, seed 3) through the raw-input kernels (K5, K7, K8) of
    the frozen bf16 NeFeS field (D8/W128/F128), each dtype's DFNet (seed
    1) aimed at the scene as chip_smoke.py's mode-2 DFNet is and
    extracting its own target features. One warm-up each, then one timed
    call each in turns (f32, bf16, bf16, f32). Returns {"<dt>_s_per_frame"
    (the mean of the dtype's two), "<dt>_final_loss" (its last call's)}
    for dt f32 and bf16."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    from nefes_tpu_torch.features.dfnet import DFNet, extract_target_features
    from nefes_tpu_torch.geometry import learn_pose
    from nefes_tpu_torch.refine import RefineConfig, refine_apr_single
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel

    dev = torch.device(args.device)
    print(_device_line(dev), flush=True)
    cfg = ModelConfig(dtype=torch.bfloat16)
    model = NeFeSModel(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    rcfg = cfg.render_config(n_samples=64, n_importance=64,
                             output_transient=False, test_time=True,
                             perturb=False, remat=False, fused=True,
                             fused_pre=False, fused_render=True,
                             fused_need_dw=False)
    full = (4 * H, 4 * W, 4 * FOCAL)
    image = torch.rand((full[0], full[1], 3),
                       generator=torch.Generator().manual_seed(3)).to(dev)
    hist = torch.zeros(10, device=dev)
    ws_vec = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    gt = torch.from_numpy(look_at_pose(np.array([0.0, 0.3, 2.4],
                                                np.float32)))
    start = learn_pose(torch.tensor([0.02, -0.03, 0.01]),
                       torch.tensor([0.05, -0.04, 0.03]), gt)[:3, :4]
    runs = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        dfnet = DFNet(output_dim=cfg.feature_dim, dtype=dt, device=dev,
                      generator=torch.Generator().manual_seed(1))
        dfnet.requires_grad_(False)
        with torch.no_grad():
            dfnet.fc_pose.weight.mul_(1e-2)
            dfnet.fc_pose.bias.copy_(start.reshape(12))
            target = extract_target_features(dfnet, image[None], full[0],
                                             full[1])[0]

        def run(dfnet=dfnet, target=target):
            return refine_apr_single(
                model, dfnet, image, target, hist, ws_vec, (H, W, FOCAL),
                full, NEAR, FAR, rcfg, RefineConfig(opt_iter=args.iters))
        runs[name] = run
        run()                                           # warm-up
    times = {name: [] for name in runs}
    last = {}
    for name in ("f32", "bf16", "bf16", "f32"):
        out = {}
        times[name].append(timeit(
            f"mode-2 {args.iters}-iteration refine ({name} DFNet)",
            lambda: out.update(runs[name]()), n=1, device=dev, warm=0))
        last[name] = out["losses"][-1]
    res = {}
    for name in runs:
        res[f"{name}_s_per_frame"] = statistics.mean(times[name])
        res[f"{name}_final_loss"] = float(last[name])
        print(f"  {name}: {res[f'{name}_s_per_frame']:.4f} s/frame, final "
              f"loss {res[f'{name}_final_loss']:.6f}", flush=True)
    print(json.dumps(res), flush=True)
    return res


# --------------------------------------------------------------------------
# accuracy: the pipeline end to end, and the pose accuracy it reaches
# --------------------------------------------------------------------------

def _host_state(module) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}


def cmd_accuracy(args) -> dict:
    """The JAX probe's accuracy pipeline, with no data from outside: a
    textured synthetic scene (args.n_train + args.n_test views at
    args.image_h x args.image_w); the NeFeS field D8/W128/F128 in bf16
    trained in three stages at H/4 (stage 0 colour, then a seeded random
    DFNet finetuned contrastively on the stage-0 field's renders, then
    stages 1 and 2 on its features); the FusionNet liveness probe and
    collapse guard; the feature quality before and after the closed-form
    BN calibration; a DFNet APR trained on the train split; then in f32
    the DFM landscape at the APR's and the true poses, mode 2 over
    args.refine_lrs x {batch, running} BN statistics with the verification
    fail-safe (and the fusion bypassed), the retreat proxies, and mode 3
    over args.mode3_lr_r x args.mode3_lr_t.

    Training runs through K5 / K6 +dW / dW (cli/train.py's "train" path),
    the frozen renders through K5, mode 2 through K5 / K7 / K8 and mode 3
    through K1 / K3 / K4 (cli/refine.py's paths); --device cpu runs their
    plain versions. The random weights are drawn as the JAX command's
    modules draw theirs (flax's initialisers, utils/init.py), from seeds
    as its keys: the field 0, the extractor 1, the steps' draws 2, the APR
    3, the negatives 7 (numpy), a fresh FusionNet 17; batch order numpy
    0. --cache keeps torch.save
    state dicts of the stage-0 field, then the trained field and the
    finetuned extractor, then the APR. Returns (and writes to args.out)
    the JAX command's result keys."""
    from dataclasses import replace

    from nefes_tpu_torch.cli.refine import KERNEL_PATHS as REFINE_PATHS
    from nefes_tpu_torch.cli.train import KERNEL_PATHS as TRAIN_PATHS
    from nefes_tpu_torch.data.synthetic import make_synthetic_scene
    from nefes_tpu_torch.evaluation import pose_errors
    from nefes_tpu_torch.features.dfnet import DFNet, extract_target_features
    from nefes_tpu_torch.refine import RefineConfig, apr_pose
    from nefes_tpu_torch.runtime import accuracy as acc
    from nefes_tpu_torch.train.calibration import calibrate_fusion_bn
    from nefes_tpu_torch.train.diagnostics import fusion_conv_liveness
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    from nefes_tpu_torch.train.trainer import (
        create_train_state, make_optimizer,
    )
    from nefes_tpu_torch.utils.image import resize_bilinear
    from nefes_tpu_torch.utils.init import lecun_normal_

    t_start = time.time()
    dev = torch.device(args.device)
    print(_device_line(dev), flush=True)
    HH, WW = args.image_h, args.image_w
    h, w = HH // acc.TINY, WW // acc.TINY
    N_TRAIN, N_TEST = args.n_train, args.n_test
    cache = args.cache
    cached = None
    if cache and os.path.exists(cache):
        cached = torch.load(cache, map_location="cpu")
        print(f"loaded trained state from {cache}", flush=True)

    scene = make_synthetic_scene(n_views=N_TRAIN + N_TEST, H=HH, W=WW,
                                 focal=1.15 * WW, texture_amp=args.texture_amp,
                                 texture_freq=args.texture_freq, device=dev)
    near, far = scene.near, scene.far
    train_idx, test_idx = acc.split_views(N_TRAIN, N_TEST)
    tr_t = torch.as_tensor(train_idx, device=dev)
    te_t = torch.as_tensor(test_idx, device=dev)
    images = torch.from_numpy(np.asarray(scene.images, np.float32)).to(dev)
    poses = torch.from_numpy(np.asarray(scene.poses, np.float32)).to(dev)
    hists = torch.from_numpy(np.asarray(scene.hists, np.float32)).to(dev)

    cfg = ModelConfig(**ARCH, dtype=torch.bfloat16)
    model = NeFeSModel(cfg, device=dev)
    lecun_normal_(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(
        model.parameters(), grad_clip=args.grad_clip))
    base = cfg.render_config(n_samples=64, n_importance=64)
    rcfg = replace(base, **TRAIN_PATHS["train"])
    # the frozen renders: the transient heads, which a test render leaves
    # out of its composite, are not computed (XLA drops them in the JAX
    # command)
    tcfg = replace(base.test(), output_transient=False,
                   **TRAIN_PATHS["test"])
    hwf = (h, w, float(scene.focal) / acc.TINY)
    full_hwf = (HH, WW, float(scene.focal))
    # the frozen feature extractor (random until finetuned)
    dfnet = DFNet(output_dim=cfg.feature_dim, dtype=torch.bfloat16,
                  device=dev)
    lecun_normal_(dfnet, torch.Generator().manual_seed(1))
    dfnet.requires_grad_(False)
    data = {"rgb": resize_bilinear(images, h, w), "poses": poses,
            "hists": hists, "train_idx": train_idx}
    order = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(2)

    @torch.no_grad()
    def extract_all(imgs, fh, fw):
        return torch.cat([extract_target_features(dfnet, imgs[i:i + 8], fh,
                                                  fw)
                          for i in range(0, imgs.shape[0], 8)])

    def save(d):
        if cache:
            torch.save(d, cache)

    if cached is not None and "variables" in cached \
            and not args.redo_stages:
        model.load_state_dict(cached["variables"])
        dfnet.load_state_dict(cached["dfvars_params"])
        train_psnr = cached["train_psnr"]
        data["feats"] = extract_all(images, h, w)
    else:
        if cached is not None and "s0_variables" in cached:
            model.load_state_dict(cached["s0_variables"])
            s0 = cached["s0_variables"]
            ep_global = args.epochs_color
            print("stage-0 field from cache", flush=True)
        else:
            _, ep_global = acc.run_stages(
                state, rcfg, data, ((0, args.epochs_color),), 0, order, gen,
                hwf, near, far)
            s0 = _host_state(model)
            save({"s0_variables": s0})
        if cached is not None and "dfvars_params" in cached:
            # --redo_stages: the finetuned extractor is kept
            dfnet.load_state_dict(cached["dfvars_params"])
            print("finetuned DFNet from cache", flush=True)
        elif args.feat_steps > 0:
            # triplets of a real image, the stage-0 field's full-size
            # render at its pose and at perturbed poses, through the
            # trainable extractor, compared at half size
            pos, neg = acc.render_contrastive_set(
                model, tcfg, poses[tr_t], hists[tr_t], full_hwf, near, far,
                args.neg_scales, np.random.default_rng(7))
            acc.finetune_dfnet(dfnet, images[tr_t], pos, neg,
                               args.feat_steps, args.feat_lr,
                               args.feat_margin, args.feat_train, gen,
                               HH // 2, WW // 2)
            del pos, neg
        data["feats"] = extract_all(images, h, w)
        metrics, _ = acc.run_stages(
            state, rcfg, data, ((1, args.epochs_feat),
                                (2, args.epochs_fusion)),
            ep_global, order, gen, hwf, near, far)
        train_psnr = float(metrics["psnr"])
        save({"variables": _host_state(model),
              "dfvars_params": _host_state(dfnet), "s0_variables": s0,
              "train_psnr": train_psnr})
    feats = data["feats"]

    # FusionNet's liveness on a training view's render; a layer under 1 %
    # live has collapsed: a fresh FusionNet and stage 2 once more
    def liveness():
        i0 = tr_t[:1]
        rgb, raw = acc.render_views(model, tcfg, poses[i0], hists[i0], hwf,
                                    near, far)
        return fusion_conv_liveness(model.fusion, rgb[0], raw[0])

    live = liveness()
    fusion_retry = False
    if any(v < 0.01 for v in live.values()):
        fusion_retry = True
        print(f"FUSION COLLAPSE detected (liveness {live}); reinit fusion "
              "+ one stage-2 retrain", flush=True)
        acc.reset_fusion(model, 17)
        state.tx = make_optimizer(model.parameters(),
                                  grad_clip=args.grad_clip)
        retry_ep = args.epochs_color + args.epochs_feat + args.epochs_fusion
        metrics, _ = acc.run_stages(state, rcfg, data,
                                    ((2, args.epochs_fusion),), retry_ep,
                                    order, gen, hwf, near, far)
        train_psnr = float(metrics["psnr"])
        live = liveness()
        save({"variables": _host_state(model),
              "dfvars_params": _host_state(dfnet), "train_psnr": train_psnr})
    print(f"fusion liveness: {live}", flush=True)
    model.requires_grad_(False)

    def cos_eval():
        return acc.feature_cos_eval(model, tcfg, poses[te_t], hists[te_t],
                                    feats[te_t], hwf, near, far)

    calibration = None
    if args.calibrate_fusion:
        cf_pre, cfr_pre, _ = cos_eval()
        K = args.calib_views
        rgbs, raws = acc.render_views(model, tcfg, poses[tr_t[:K]],
                                      hists[tr_t[:K]], hwf, near, far)
        calibration = calibrate_fusion_bn(model, rgbs, raws, feats[tr_t[:K]])
        calibration["views"] = K
        calibration["feat_cos_fused_precal"] = round(float(np.mean(cf_pre)),
                                                     4)
        calibration["feat_cos_fused_running_precal"] = round(
            float(np.mean(cfr_pre)), 4)
        print("fusion BN calibration:", json.dumps(calibration), flush=True)
    cos_fused, cos_fused_run, cos_raw = cos_eval()

    # the DFNet APR, trained on the train split
    apr = DFNet(output_dim=cfg.feature_dim, dtype=torch.bfloat16, device=dev)
    lecun_normal_(apr, torch.Generator().manual_seed(3))
    if cached is not None and "apr_params" in cached and not args.redo_apr:
        apr.load_state_dict(cached["apr_params"])
        print("APR from cache", flush=True)
    else:
        acc.train_apr(apr, images, poses.reshape(-1, 12), train_idx,
                      args.apr_steps, args.apr_lr, gen)
        if cache and os.path.exists(cache):
            cdict = torch.load(cache, map_location="cpu")
            cdict["apr_params"] = _host_state(apr)
            torch.save(cdict, cache)
            print(f"saved APR to {cache}", flush=True)
    apr.requires_grad_(False)

    # refinement in f32: the trained parameters under f32 modules
    test_imgs, test_hists = images[te_t], hists[te_t]
    targets = extract_all(test_imgs, HH, WW)
    cfg_r = replace(cfg, dtype=torch.float32)
    model_r = NeFeSModel(cfg_r, device=dev)
    model_r.load_state_dict(model.state_dict())
    model_r.requires_grad_(False)
    apr_r = DFNet(output_dim=cfg.feature_dim, dtype=torch.float32, device=dev)
    apr_r.load_state_dict(apr.state_dict())
    apr_r.requires_grad_(False)
    base_r = cfg_r.render_config(n_samples=64, n_importance=64,
                                 output_transient=False, perturb=False).test()
    land_cfg = replace(base_r, **TRAIN_PATHS["test"])

    # the DFM landscape: the loss the refiner descends, at the APR's pose
    # and at the true one, fused (both BN modes) and raw
    with torch.no_grad():
        apr_poses0 = torch.stack([apr_pose(apr, test_imgs[i], svd_reg=True)
                                  for i in range(N_TEST)])
        packed = model_r.pack_fused()
    at_init, at_gt = (np.array([
        acc.dfm_losses_at(model_r, land_cfg, p[i], test_hists[i], targets[i],
                          hwf, (HH, WW), near, far, packed)
        for i in range(N_TEST)]) for p in (apr_poses0, poses[te_t]))
    landscape = acc.landscape_summary(at_init, at_gt)
    print("DFM landscape:", json.dumps(landscape), flush=True)
    ws_vec = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    gt = scene.poses[test_idx]
    m2_cfg = replace(base_r, **REFINE_PATHS[2])

    def run_refine(lr, iters, per_pixel=False, fusion="batch"):
        return acc.run_refine(model_r, apr_r, test_imgs, targets, test_hists,
                              ws_vec, hwf, full_hwf, near, far, m2_cfg, gt,
                              lr, iters, per_pixel, fusion,
                              args.refine_chunk)

    configs = [(lr, args.opt_iter, bool(args.per_pixel))
               for lr in args.refine_lrs]
    if args.sweep_pp:
        configs += [(lr, args.opt_iter, not bool(args.per_pixel))
                    for lr in args.refine_lrs]
    if args.sweep_refine:
        configs += [(2e-6, 150, False), (1e-5, 50, True), (7e-6, 50, True),
                    (5e-6, 50, True), (5e-6, 100, True), (3e-6, 100, True)]
    if args.sweep_small:
        configs = [(lr, args.opt_iter, True) for lr in args.refine_lrs] \
            + [(2e-6, 150, False)]
    # both BN operating points; the headline is the best over both
    runs = [run_refine(*c) for c in configs] \
        + [run_refine(*c, fusion="running") for c in configs]
    for r in runs:
        print(f"refine lr={r['lr']} iters={r['iters']} pp={r['per_pixel']} "
              f"fusion={r['fusion']}: median {r['median_t']:.4f} m / "
              f"{r['median_r']:.3f} deg (init "
              f"{np.median(r['err_init'][:, 0]):.4f} m / "
              f"{np.median(r['err_init'][:, 1]):.3f} deg)", flush=True)
    best = min(runs, key=lambda r: r["median_t"])

    # the same sweep with the FusionNet bypassed (raw rendered features)
    raw_runs = [run_refine(*c, fusion="none") for c in configs]
    fusion_ablation = {}
    for name, sel in (("fused_batch", [r for r in runs
                                       if r["fusion"] == "batch"]),
                      ("raw", raw_runs),
                      ("fused_running", [r for r in runs
                                         if r["fusion"] == "running"])):
        r = min(sel, key=lambda r: r["median_t"])
        fusion_ablation[name] = {
            "lr": r["lr"], "median_t_m": r["median_t"],
            "median_r_deg": r["median_r"],
            "improved_frames_frac": float(np.mean(
                r["err_ver"][:, 0] < r["err_init"][:, 0]))}
        print(f"fusion ablation {name}: {fusion_ablation[name]}", flush=True)
    out, verified = best["out"], best["verified"]
    refined, init_poses = best["refined"], best["init_poses"]
    err_init, err_ver = best["err_init"], best["err_ver"]
    err_ref = pose_errors(refined, gt)
    # the landscape column of the headline's BN mode
    win_col = 0 if best["fusion"] == "batch" else 2
    retreated = np.any(verified != refined, axis=(1, 2))
    ver_confusion, degraded = acc.verification_confusion(err_init, err_ref,
                                                         retreated)
    proxies = acc.proxy_comparison(np.asarray(out["losses"]), retreated,
                                   degraded, init_poses, refined, gt,
                                   err_init)
    print("proxy comparison:", json.dumps(proxies), flush=True)

    # mode 3 from the APR's poses, lr_r x lr_t swept
    targets_rs = extract_all(test_imgs, h, w)
    err_m3_init = pose_errors(apr_poses0.cpu().numpy(), gt)
    m3_cfg = replace(base_r, **REFINE_PATHS[3])
    ch3 = max(1, 2 * args.refine_chunk)
    m3_runs = []
    for lr_r in args.mode3_lr_r:
        for lr_t in args.mode3_lr_t:
            rfc3 = RefineConfig(opt_iter=args.opt_iter, lr_r=lr_r, lr_t=lr_t,
                                per_pixel=best["per_pixel"],
                                fusion=best["fusion"])
            parts = [acc.refine_poses_batch(
                model_r, apr_poses0[s:s + ch3], targets_rs[s:s + ch3],
                test_hists[s:s + ch3], scene.world, hwf, m3_cfg,
                rfc3)[0].cpu().numpy() for s in range(0, N_TEST, ch3)]
            e = pose_errors(np.concatenate(parts), gt)
            m3_runs.append({
                "lr_r": lr_r, "lr_t": lr_t,
                "median_t_m": float(np.median(e[:, 0])),
                "median_r_deg": float(np.median(e[:, 1])),
                "improved_t_frac": float(np.mean(e[:, 0]
                                                 < err_m3_init[:, 0])),
                "improved_r_frac": float(np.mean(e[:, 1]
                                                 < err_m3_init[:, 1]))})
            print(f"mode-3 lr_r={lr_r} lr_t={lr_t}: {m3_runs[-1]}",
                  flush=True)
    t0m, r0m = (float(np.median(err_m3_init[:, 0])),
                float(np.median(err_m3_init[:, 1])))
    best_m3 = acc.best_mode3(m3_runs, t0m, r0m)
    verdict = "improves" if best_m3["median_r_deg"] <= r0m else "DEGRADES"
    mode3 = {
        "mode3_median_t_after_m": best_m3["median_t_m"],
        "mode3_median_r_after_deg": best_m3["median_r_deg"],
        "mode3_median_t_before_m": t0m,
        "mode3_median_r_before_deg": r0m,
        "mode3_improved_frames_frac": best_m3["improved_t_frac"],
        "mode3_improved_rot_frames_frac": best_m3["improved_r_frac"],
        "mode3_lr_r": best_m3["lr_r"],
        "mode3_lr_t": best_m3["lr_t"],
        "mode3_lr_r_sweep": m3_runs,
        "mode3_note": (
            "lr_r swept; best by summed relative (t, r) improvement. "
            f"rotation median {verdict} vs the unrefined APR ({r0m:.3f} -> "
            f"{best_m3['median_r_deg']:.3f} deg) — reported either way."),
    }
    print("mode-3:", json.dumps(mode3), flush=True)

    result = {
        "pipeline": "3-stage train -> DFNet APR -> mode-2 + verification",
        "image_hw": [HH, WW], "n_train_views": int(N_TRAIN),
        "field": "D8/W128/F128 bf16",
        "opt_iter": best["iters"], "frames": int(N_TEST),
        "per_pixel_dfm": best["per_pixel"],
        "train_psnr_db": round(train_psnr, 2),
        "refine_lr": best["lr"],
        "feat_cos_loss_fused_renderscale": round(float(np.mean(cos_fused)),
                                                 4),
        "feat_cos_loss_fused_running_renderscale": round(
            float(np.mean(cos_fused_run)), 4),
        "feat_cos_loss_raw_renderscale": round(float(np.mean(cos_raw)), 4),
        "headline_fusion_bn": best["fusion"],
        "fusion_beats_raw_at_dfm_scale": bool(
            float(np.median(at_init[:, win_col]))
            < landscape["dfm_loss_at_init_raw"]),
        "fusion_relief_beats_raw": bool(
            acc.relief(at_init, at_gt, win_col)
            >= landscape["dfm_relief_raw_pct"]),
        "fusion_ablation": fusion_ablation,
        "fusion_beats_raw_final_medians": bool(
            best["median_t"] <= fusion_ablation["raw"]["median_t_m"]),
        "median_t_before_m": float(np.median(err_init[:, 0])),
        "median_t_after_m": float(np.median(err_ver[:, 0])),
        "median_r_before_deg": float(np.median(err_init[:, 1])),
        "median_r_after_deg": float(np.median(err_ver[:, 1])),
        "median_t_after_no_verif_m": float(np.median(err_ref[:, 0])),
        "median_r_after_no_verif_deg": float(np.median(err_ref[:, 1])),
        "retreat_frames": int(np.sum(retreated)),
        "frames_worse_after_verification": int(np.sum(
            err_ver[:, 0] > err_init[:, 0] + 1e-9)),
        "verification_confusion": ver_confusion,
        "proxy_comparison": proxies,
        "improved_frames_frac": float(np.mean(err_ver[:, 0]
                                              < err_init[:, 0])),
        "dfm_relief_fused_pct": acc.relief(at_init, at_gt, win_col),
        **mode3,
        **landscape,
        "fusion_liveness": live,
        "fusion_collapse_retry": fusion_retry,
        "fusion_bn_calibration": calibration,
        "grad_clip": args.grad_clip,
        "texture_amp": args.texture_amp,
        "texture_freq": args.texture_freq,
        "wall_s": round(time.time() - t_start, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    result["t_improvement_x"] = round(
        result["median_t_before_m"] / max(result["median_t_after_m"], 1e-9),
        2)
    result["r_improvement_x"] = round(
        result["median_r_before_deg"]
        / max(result["median_r_after_deg"], 1e-9), 2)
    print(json.dumps(result, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


# --------------------------------------------------------------------------
# inscan_ab and profile: the refinement frame, by kernel path and by phase
# --------------------------------------------------------------------------

def _refine_inputs(dev) -> dict:
    """The JAX commands' refinement inputs: the NeFeS field in bf16
    (seed 0, frozen), the pose look_at_pose([0, 0.3, 2.4]), a zero
    histogram, ws_vec [1, 1, 0, 0, 0], the render geometry (H, W, FOCAL)
    and mode 2's query geometry (4H, 4W, 4 FOCAL), and the base render
    config: 64 + 64 samples at test time, no kernel."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    cfg = ModelConfig(dtype=torch.bfloat16)
    model = NeFeSModel(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    pose = torch.from_numpy(look_at_pose(
        np.array([0.0, 0.3, 2.4], np.float32))).to(dev)
    return {"model": model, "pose": pose,
            "hist": torch.zeros(10, device=dev),
            "ws_vec": torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev),
            "hwf": (H, W, FOCAL), "full": (4 * H, 4 * W, 4 * FOCAL),
            "base": cfg.render_config(n_samples=64, n_importance=64,
                                      output_transient=False,
                                      test_time=True, perturb=False,
                                      remat=False)}


def _query(dev, dtype, feature_dim: int, hw: tuple) -> tuple:
    """Mode 2's query: an image uniform in [0, 1) (seed 3), DFNet in dtype
    (seed 1, frozen) and DFNet's own features of the image, full size."""
    from nefes_tpu_torch.features.dfnet import DFNet, extract_target_features
    img = torch.rand((hw[0], hw[1], 3),
                     generator=torch.Generator().manual_seed(3)).to(dev)
    dfnet = DFNet(output_dim=feature_dim, dtype=dtype, device=dev,
                  generator=torch.Generator().manual_seed(1))
    dfnet.requires_grad_(False)
    with torch.no_grad():
        target = extract_target_features(dfnet, img[None], hw[0], hw[1])[0]
    return img, dfnet, target


def _refiners(captured: bool) -> tuple:
    """(mode 3, mode 2) refinement of one frame: the captured loops that
    serve on the card, or the eager loops."""
    from nefes_tpu_torch.refine import (
        refine_apr_captured, refine_apr_single, refine_pose_captured,
        refine_pose_single,
    )
    return ((refine_pose_captured, refine_apr_captured) if captured
            else (refine_pose_single, refine_apr_single))


def cmd_inscan_ab(args) -> dict:
    """The JAX command's A/B of the kernel-integration variants inside the
    real 50-iteration refinement (its in_scan_ab_s_per_frame table):

      unfused    plain PyTorch (the JAX package's XLA-fused default)
      fused_raw  the raw-input field kernels (K5, K6)
      fused_pre  the pre-embedded field kernels (K1, K2)
      render_pre the pre-embedded field kernel and the composite-fused
                 fine pass (K1, K3, K4)

    Mode 3 through refine_pose_single's loop (lr_r 0.0087, lr_t 0.01, a
    zero target), mode 2 through refine_apr_single's (the bf16 DFNet,
    svd_reg) on the 4H x 4W query, ITERS iterations, 7-Scenes geometry.
    On the card render_pre runs as the port serves it, through the
    captured loop (refine/graph.py); the others run eager: their fine
    pass composites through the plain compositor, whose cumprod backward
    cannot be captured. s/frame is probe.timeit's median of 3 frames
    after 2 warm ones."""
    from dataclasses import replace

    from nefes_tpu_torch.refine import RefineConfig, graph

    dev = torch.device(args.device)
    print(_device_line(dev), flush=True)
    ins = _refine_inputs(dev)
    model, pose, hist, ws_vec = (ins[k] for k in ("model", "pose", "hist",
                                                  "ws_vec"))
    base, hwf, full = ins["base"], ins["hwf"], ins["full"]
    variants = {
        "unfused": base,
        "fused_raw": replace(base, fused=True, fused_need_dw=False),
        "fused_pre": replace(base, fused=True, fused_pre=True,
                             fused_need_dw=False),
        "render_pre": replace(base, fused=True, fused_pre=True,
                              fused_render=True, fused_need_dw=False),
    }
    how = {name: ("captured" if dev.type == "cuda" and rcfg.fused_render
                  else "eager") for name, rcfg in variants.items()}
    results = {"mode3": {}, "mode2_bf16": {}}

    target = torch.zeros((H, W, model.cfg.feature_dim), device=dev)
    rfc3 = RefineConfig(opt_iter=ITERS, lr_r=0.0087, lr_t=0.01)
    for name, rcfg in variants.items():
        run3, _ = _refiners(how[name] == "captured")
        dt = timeit(f"mode-3 refine [{name}, {how[name]}]", lambda: run3(
            model, pose, target, hist, ws_vec, hwf, NEAR, FAR, rcfg, rfc3),
            n=3, device=dev)
        results["mode3"][name] = round(dt, 4)
        graph.clear()

    img, dfnet, tgt = _query(dev, torch.bfloat16, model.cfg.feature_dim,
                             full)
    rfc2 = RefineConfig(opt_iter=ITERS)
    for name, rcfg in variants.items():
        _, run2 = _refiners(how[name] == "captured")
        dt = timeit(f"mode-2 refine [{name}, {how[name]}]", lambda: run2(
            model, dfnet, img, tgt, hist, ws_vec, hwf, full, NEAR, FAR,
            rcfg, rfc2, svd_reg=True), n=3, device=dev)
        results["mode2_bf16"][name] = round(dt, 4)
        graph.clear()

    print("inscan_ab: " + ", ".join(f"{k} {v}" for k, v in how.items()),
          flush=True)
    out = {"what": f"s/frame of the {ITERS}-iteration refinement per "
                   "kernel-integration variant (render_pre through the "
                   "captured loop on the card, the others eager; median "
                   "of 3 frames)",
           "device": _device_line(dev)[len("device: "):],
           "in_scan_ab_s_per_frame": results}
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def refinement_kernel_bytes(packed, rays: int, n_c: int = 64,
                            n_f: int = 128) -> dict:
    """Bytes of one launch of each refinement kernel, by the wrapper that
    launches it, at `rays` rays (K1/K5 in sigma mode on the coarse pass's
    rays x n_c samples, the others on the fine pass's rays x n_f): each
    input read once, each output written once, and the tower's weights
    (the rules of chip_smoke.py's time phase). packed is
    model.pack_fused()'s (coarse, fine)."""
    from dataclasses import replace

    from nefes_tpu_torch.kernels import fused_field as kf
    pc, pf = packed
    sp = pf.spec
    e, b4 = sp.torch_dtype.itemsize, 4
    Nc, Nf = rays * n_c, rays * n_f
    ray_out = rays * (sp.rgbfeat + 2) * b4
    pre = sp.emb_xyz + sp.emb_dir

    def weights(p):
        static = replace(p.spec, transient=False)
        return (sum(p.weights[k].numel() for k in kf.matrix_names(static)) * e
                + sum(p.weights[k].numel() for k in kf.bias_names(static))
                * b4)
    wc, wf = weights(pc), weights(pf)
    return {
        "field_fwd_pre": Nc * (sp.emb_xyz + 1) * e + wc,
        "field_bwd_pre": Nf * (2 * pre + sp.rgbfeat + 1) * e + wf,
        "render_fwd_pre": Nf * pre * e + Nf * b4 + ray_out + wf,
        "render_bwd_pre": 2 * Nf * pre * e + 2 * Nf * b4 + ray_out + wf,
        "field_fwd": Nc * (3 + 1) * b4 + wc,
        "field_bwd": Nf * (4 * 3 + sp.rgbfeat + 1) * b4 + wf,
        "render_fwd": Nf * (2 * 3 + 1) * b4 + ray_out + wf,
        "render_bwd": 2 * Nf * (2 * 3 + 1) * b4 + ray_out + wf,
    }


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# seconds the trace runs before fn: on an H100 the first 24-27 kernels
# launched right after the profiler started were missing from the trace
# in three of six traced refinement steps
TRACE_SETTLE_S = 0.2


def _profiled(fn, dev):
    """(the torch.profiler run of fn, fn's wall seconds): CPU and, on the
    card, CUDA activity, with Python stacks, input shapes and memory."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts, with_stack=True, record_shapes=True,
                 profile_memory=True) as prof:
        if dev.type == "cuda":
            time.sleep(TRACE_SETTLE_S)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return prof, wall


def _order_report(tag: str, ops, reference) -> None:
    """Print how the first replay's kernels line up with the eager step's:
    the counts, and the kernels one launches more often than the other."""
    from collections import Counter
    first = Counter(o.name for o in ops if o.replay == 0)
    ref = Counter(o.name for o in reference)
    more, fewer = first - ref, ref - first
    line = (f"profile {tag}: a replay launches {sum(first.values())} "
            f"kernels, the eager step {sum(ref.values())}")
    if more or fewer:
        line += (f"; the replay more often: {dict(more.most_common(3))}, "
                 f"less often: {dict(fewer.most_common(3))}")
    print(line, flush=True)


def cmd_profile(args) -> dict:
    """The JAX command's per-phase breakdown of a refinement frame, from a
    torch.profiler trace of the path the port's refine CLI serves
    (cli/refine.py KERNEL_PATHS): mode 3 through K1, K3, K4 and mode 2
    (DFNet in each of args.dtypes) through K5, K7, K8, 50 iterations a
    frame, each frame replaying the captured iteration (refine/graph.py)
    on the card, eager on the CPU. The JAX command's inputs (its
    geometry, 64 + 64 samples, the bf16 field, its seeds by role).

    A leg: two warm frames; on the card one eager iteration of the
    captured loop's own step, profiled, whose kernels, in launch order,
    name the replayed ones (runtime/xprof.py attribute's reference); then
    args.frames frames profiled. The wall time is taken inside the trace,
    from the first frame's start to the last one's synchronise. Each
    leg has the JAX leg's keys, hbm_peak_gbps the H100's 3350 GB/s (the
    rate probe.bound uses), plus how many ops were attributed which way
    and the ms per frame of each phase whose bytes were not reckoned."""
    from nefes_tpu_torch.cli.refine import KERNEL_PATHS
    from dataclasses import replace

    from nefes_tpu_torch.refine import (
        RefineConfig, graph, render_feature_image,
    )
    from nefes_tpu_torch.refine.pose_opt import on_card
    from nefes_tpu_torch.runtime import xprof

    dev = torch.device(args.device)
    print(_device_line(dev), flush=True)
    NFRAMES = args.frames
    ins = _refine_inputs(dev)
    model, pose, hist, ws_vec = (ins[k] for k in ("model", "pose", "hist",
                                                  "ws_vec"))
    hwf, full = ins["hwf"], ins["full"]
    captured = on_card(pose)
    run_pose, run_apr = _refiners(captured)
    rcfg = RefineConfig(opt_iter=ITERS, lr_r=0.0087, lr_t=0.01)
    with torch.no_grad():
        kbytes = refinement_kernel_bytes(model.pack_fused(), H * W)
    HBM_GBPS = PEAK_BYTES / 1e9
    report = {"what": (f"per-phase device time of one refinement frame "
                       f"({ITERS} iterations) from a torch.profiler trace; "
                       f"kernels tied to the innermost frame of the port "
                       f"around their launch (runtime/xprof.py), backward "
                       f"ops to their forward op's; "
                       + ("kernels replayed from the captured iteration's "
                          "CUDA graph attributed by their order in one "
                          "eager run of the same step" if captured else
                          "on the CPU: the torch ops' self time")),
              "device": _device_line(dev)[len("device: "):],
              "geometry": {"render_hw": [H, W], "full_hw": list(full[:2])},
              "frames_traced": NFRAMES}

    def trace_and_attribute(tag, run):
        graph.clear()
        for wrm in range(2):
            run(wrm)
        reference = None
        if captured:
            (loop,) = graph.loops()
            loop._release_grads()      # as before the capture
            loop._reset()
            prof, _ = _profiled(loop._step, dev)
            reference, _, _ = xprof.load_ops(prof, kbytes)
            loop._release_grads()

        def frames():
            for i in range(NFRAMES):
                run(i + 2)
        prof, wall = _profiled(frames, dev)
        wall /= NFRAMES
        ops, busy_ms, span_ms = xprof.load_ops(prof, kbytes)
        if captured and not any(op.replay is not None for op in ops):
            raise RuntimeError(f"profile {tag}: no replayed kernel in the "
                               "trace")
        phases, per_op, phase_bytes = xprof.attribute(ops, reference,
                                                      want_bytes=True)
        graph.clear()
        if reference is not None:
            _order_report(tag, ops, reference)
        phases_frame = {k: round(v / NFRAMES, 3) for k, v in phases.items()}
        top = [{"ms_per_frame": round(ms / NFRAMES, 3), "op": name,
                "opcode": opcode, "phase": cat, "count": cnt // NFRAMES}
               for ms, name, opcode, cat, cnt in per_op[:args.top]]
        floors, unreckoned = {}, {}
        for k, ms in phases.items():
            pb = phase_bytes.get(k)
            if pb and pb["ms"] > 0:
                gbps = pb["bytes"] / 1e9 / (pb["ms"] / 1e3)
                floors[k] = {"bytes_per_frame_mb": round(
                                 pb["bytes"] / 1e6 / NFRAMES, 1),
                             "achieved_gbps_upper_bound": round(gbps, 1),
                             "hbm_roofline_frac": round(gbps / HBM_GBPS, 3)}
            left = ms - (pb["ms"] if pb else 0.0)
            if left > 1e-9:
                unreckoned[k] = round(left / NFRAMES, 3)
        how = {}
        for op in ops:
            how[op.how] = how.get(op.how, 0) + 1
        busy_f = busy_ms / NFRAMES
        leg = {"wall_s_per_frame": round(wall, 4),
               "device_busy_ms_per_frame": round(busy_f, 1),
               "device_span_ms_per_frame": round(span_ms / NFRAMES, 1),
               "host_gap_ms_per_frame": round(wall * 1000 - busy_f, 1),
               "phases_ms_per_frame": phases_frame,
               "hbm_peak_gbps": HBM_GBPS,
               "phase_bandwidth_floors": floors,
               "top_ops": top,
               "bytes_not_reckoned_ms_per_frame": unreckoned,
               "ops_attributed_by": how}
        print(f"\n=== {tag}: wall {wall:.3f} s/frame, device busy "
              f"{busy_f:.1f} ms, host gap {leg['host_gap_ms_per_frame']} "
              f"ms; ops attributed by {how} ===", flush=True)
        width = max((len(k) for k in phases_frame), default=1)
        for k, v in phases_frame.items():
            fl = floors.get(k)
            bw = (f"  {fl['achieved_gbps_upper_bound']:7.1f} GB/s "
                  f"({fl['hbm_roofline_frac'] * 100:3.0f}% HBM)"
                  if fl else "  bytes not reckoned")
            print(f"  {k:<{width}}  {v:8.3f} ms "
                  f"({v / max(busy_f, 1e-12) * 100:4.1f}% of busy){bw}")
        print("  -- top ops --")
        for t in top[:12]:
            print(f"  {t['ms_per_frame']:8.3f} ms x{t['count']:>4} "
                  f"[{t['phase']}] {t['op'][:70]} ({t['opcode'][:90]})")
        return leg

    if args.mode in ("3", "both"):
        cfg3 = replace(ins["base"], **KERNEL_PATHS[3])
        with torch.no_grad():
            _, target3 = render_feature_image(model, pose, hist, hwf, NEAR,
                                              FAR, cfg3)

        def run3(i):
            moved = pose.clone()
            moved[:, 3] += 1e-5 * i
            return run_pose(model, moved, target3, hist, ws_vec, hwf, NEAR,
                            FAR, cfg3, rcfg)[1]
        report["mode3"] = trace_and_attribute("mode3", run3)

    if args.mode in ("2", "both"):
        cfg2 = replace(ins["base"], **KERNEL_PATHS[2])
        for dt_name in args.dtypes:
            dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
            img, dfnet, target2 = _query(dev, dt, model.cfg.feature_dim,
                                         full)

            def run2(i, img=img, dfnet=dfnet, target2=target2):
                return run_apr(model, dfnet, (img + 1e-5 * i).clamp(0, 1),
                               target2, hist, ws_vec, hwf, full, NEAR, FAR,
                               cfg2, rcfg)["losses"]
            report[f"mode2_{dt_name}"] = trace_and_attribute(
                f"mode2_{dt_name}", run2)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nwrote {args.out}", flush=True)
    return report


# --------------------------------------------------------------------------
# golden: the paper-parity run in one command
# --------------------------------------------------------------------------

def cmd_golden(args) -> dict:
    """Convert, refine and evaluate against the reference's paper_result
    medians in one call (the JAX command's argv and verdict): the released
    NeFeS .tar and DFNet .pt (reference README.md:62-68) through the
    port's refine CLI in mode 2 with the released DFM configs' settings,
    then its medians against DFNet + NeFeS50's recorded ones. Raises
    SystemExit (non-zero) when they miss by more than the tolerances,
    prints "[golden] PASS" otherwise. Held on a synthetic reference-layout
    fixture by tests/test_torch_golden.py."""
    from nefes_tpu_torch.cli.refine import main as refine_main
    from nefes_tpu_torch.evaluation.golden import (
        evaluate_scene, paper_result_dir,
    )

    argv = [
        "--dataset_type", args.dataset_type, "--pose_only", "2",
        "--datadir", args.datadir, "--data_root", args.data_root,
        "--ft_path", args.tar,
        "--pretrain_model_path", args.apr,
        "--pretrain_featurenet_path", args.featurenet or args.apr,
        "--df", str(args.df), "--tinyscale", "4",
        "--opt_iter", str(args.opt_iter),
        "--apr_compute_dtype", args.apr_compute_dtype,
        # the released DFM configs' settings (config_chess_DFM.txt:19-22)
        "--freezeBN", "true", "--svd_reg", "true",
        "--device", args.device,
    ]
    if args.extra_args:
        argv += args.extra_args
    print("[golden] refine:", " ".join(argv), flush=True)
    ours = refine_main(argv)

    scene_dir = paper_result_dir(args.ref, args.dataset_type) / args.scene
    paper = evaluate_scene(scene_dir, args.scene, refined=True)
    paper_apr = evaluate_scene(scene_dir, args.scene, refined=False)

    dt = float(ours["median_t_m"]) - float(paper["median_t_m"])
    dr = float(ours["median_r_deg"]) - float(paper["median_r_deg"])
    ok = dt <= args.tol_t and dr <= args.tol_r
    verdict = {
        "scene": args.scene, "dataset": args.dataset_type,
        "ours_median_t_m": float(ours["median_t_m"]),
        "ours_median_r_deg": float(ours["median_r_deg"]),
        "paper_median_t_m": float(paper["median_t_m"]),
        "paper_median_r_deg": float(paper["median_r_deg"]),
        "paper_apr_median_t_m": float(paper_apr["median_t_m"]),
        "paper_apr_median_r_deg": float(paper_apr["median_r_deg"]),
        "delta_t_m": round(dt, 5), "delta_r_deg": round(dr, 4),
        "tol_t_m": args.tol_t, "tol_r_deg": args.tol_r,
        "pass": bool(ok),
    }
    print(json.dumps(verdict, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
    if not ok:
        raise SystemExit(
            f"[golden] FAIL: medians miss paper_result by "
            f"dt={dt:+.4f} m (tol {args.tol_t}), "
            f"dr={dr:+.3f} deg (tol {args.tol_r})")
    print("[golden] PASS", flush=True)
    return verdict


def parser() -> argparse.ArgumentParser:
    """The commands and their flags; accuracy's are the JAX command's at
    its defaults (runtime/probe.py:1719-1800) but --out."""
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
    p2 = sub.add_parser("mode2", parents=[common])
    p2.add_argument("--iters", type=int, default=50,
                    help="refinement iterations a frame")
    pa = sub.add_parser("accuracy", parents=[common])
    pa.add_argument("--image_h", type=int, default=192)
    pa.add_argument("--image_w", type=int, default=256)
    pa.add_argument("--n_train", type=int, default=60)
    pa.add_argument("--epochs_color", type=int, default=120)
    pa.add_argument("--epochs_feat", type=int, default=100)
    pa.add_argument("--epochs_fusion", type=int, default=200)
    pa.add_argument("--apr_steps", type=int, default=1500)
    pa.add_argument("--apr_lr", type=float, default=2e-4)
    pa.add_argument("--refine_lrs", type=float, nargs="+",
                    default=[6e-6, 4e-6, 3e-6],
                    help="mode-2 APR learning rates swept")
    pa.add_argument("--opt_iter", type=int, default=50)
    pa.add_argument("--n_test", type=int, default=32)
    pa.add_argument("--per_pixel", type=int, default=1,
                    help="per-pixel DFM loss for the main lr sweep")
    pa.add_argument("--sweep_refine", action="store_true")
    pa.add_argument("--sweep_small", action="store_true")
    pa.add_argument("--feat_steps", type=int, default=600)
    pa.add_argument("--feat_lr", type=float, default=5e-5)
    pa.add_argument("--feat_margin", type=float, default=0.3)
    pa.add_argument("--feat_train", choices=["all", "adapt"], default="all",
                    help="finetune every DFNet group but fc_pose, or the "
                         "adapt blocks only")
    pa.add_argument("--neg_scales", type=float, nargs="+", default=[1.0, 0.5],
                    help="pose-perturbation scales of the contrastive "
                         "negatives")
    pa.add_argument("--mode3_lr_r", type=float, nargs="+",
                    default=[0.001, 0.002, 0.004])
    pa.add_argument("--mode3_lr_t", type=float, nargs="+", default=[0.01])
    pa.add_argument("--sweep_pp", action="store_true",
                    help="also run the refine_lrs with the opposite "
                         "per_pixel setting")
    pa.add_argument("--redo_apr", action="store_true",
                    help="retrain the APR even if the cache has one")
    pa.add_argument("--cache", default="",
                    help="torch.save path to keep and reuse the trained "
                         "field, extractor and APR")
    pa.add_argument("--texture_freq", type=float, default=1.0)
    pa.add_argument("--calibrate_fusion", type=int, default=1,
                    help="closed-form trailing-BN affine calibration after "
                         "training")
    pa.add_argument("--calib_views", type=int, default=6)
    pa.add_argument("--refine_chunk", type=int, default=8,
                    help="frames a refine_apr_batch call (mode 3: twice)")
    pa.add_argument("--texture_amp", type=float, default=0.6)
    pa.add_argument("--grad_clip", type=float, default=1.0,
                    help="global-norm clip of field training (0 = off)")
    pa.add_argument("--redo_stages", action="store_true",
                    help="retrain stages 1-2 from the cache's stage-0 field "
                         "and finetuned extractor")
    pa.add_argument("--out", default="ACCURACY_torch.json")
    pi = sub.add_parser("inscan_ab", parents=[common])
    pi.add_argument("--out", default="")
    pp = sub.add_parser("profile", parents=[common])
    pp.add_argument("--mode", choices=["2", "3", "both"], default="both")
    pp.add_argument("--dtypes", nargs="+", default=["bf16"],
                    choices=["f32", "bf16"])
    pp.add_argument("--frames", type=int, default=2)
    pp.add_argument("--top", type=int, default=25)
    pp.add_argument("--out", default="PROFILE_torch.json")
    pg = sub.add_parser("golden", parents=[common])
    pg.add_argument("--tar", required=True,
                    help="released NeFeS checkpoint (.tar)")
    pg.add_argument("--apr", required=True,
                    help="released DFNet APR checkpoint (.pt)")
    pg.add_argument("--featurenet", default="",
                    help="FeatureNet .pt (defaults to --apr)")
    pg.add_argument("--scene", required=True)
    pg.add_argument("--datadir", required=True)
    pg.add_argument("--data_root", default="data")
    pg.add_argument("--dataset_type", default="7Scenes_colmap",
                    choices=["7Scenes", "7Scenes_colmap", "Cambridge"])
    pg.add_argument("--ref", required=True,
                    help="the reference checkout holding paper_result/")
    pg.add_argument("--df", type=int, default=2)
    pg.add_argument("--opt_iter", type=int, default=50)
    pg.add_argument("--apr_compute_dtype", default="bfloat16")
    pg.add_argument("--tol_t", type=float, default=0.005,
                    help="allowed median-translation excess vs paper (m)")
    pg.add_argument("--tol_r", type=float, default=0.2,
                    help="allowed median-rotation excess vs paper (deg)")
    pg.add_argument("--out", default="GOLDEN_torch.json")
    pg.add_argument("--extra_args", nargs=argparse.REMAINDER, default=[],
                    help="passed through to the refine CLI")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        p.error("no CUDA device; --device cpu runs the plain versions")
    {"kernelmicro": cmd_kernelmicro, "kernel": cmd_kernel,
     "perf": cmd_perf, "mode2": cmd_mode2, "accuracy": cmd_accuracy,
     "inscan_ab": cmd_inscan_ab, "profile": cmd_profile,
     "golden": cmd_golden}[args.cmd](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
