"""On-card smoke run of nefes_tpu_torch on one NVIDIA GPU (written for the
H100: the kernels build for sm_90a).

    python3 chip_smoke.py [--phases build,check,mode3,mode2,paths,time]

Phases:
  build  compile the CUDA kernels from csrc/ (nvcc, one process per
         source, in parallel) into nefes_tpu_torch/_build/
  check  K1-K8 against their plain PyTorch versions on the card, at the
         shapes of the refinement's main path, in bf16 and f32
  mode3  mode-3 refinement at full width (NeFeS D8/W128/F128 in bf16,
         60x80 rays, 64+64 samples) through the pre-embedded kernels
         (fused=fused_pre=fused_render=True, frozen field: K1, K3, K4):
         time per frame, losses, launch counts, peak memory
  mode2  mode-2 refinement at full width (DFNet in f32 on a 240x320
         query, the same NeFeS field and render) through the raw-input
         kernels (fused=fused_render=True, fused_pre=False: K5, K7, K8):
         one warm-up frame, one timed frame with losses, PSNR/SSIM, the
         verification's decision, launch counts and peak memory; then
         one timed frame through the pre-embedded kernels (K1, K3, K4)
  paths  a few iterations of each mode through the other paths: mode 3
         with fused_render=False (K1 + K2), unfused (plain PyTorch) and
         the raw paths (K5 + K7/K8, K5 + K6); mode 2 through the raw
         paths, the pre-embedded render and unfused. Their losses must
         agree with the mode's first path's
  time   each kernel's time (CUDA events, median) beside its bound, its
         plain version's time and a bf16 torch.matmul chain over the same
         tower as a yardstick

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed phase exits with 1 and prints
no result; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
H, W, FOCAL = 60, 80, 525.505 / 8
NEAR, FAR = 0.0, 4.0
N_C, N_F = 64, 64
ITERS = 50
# Kernel vs plain: relative L2 error ||kernel - plain|| / ||plain|| per
# output. In bf16 the two sum in another order (tensor cores vs cuBLAS),
# so a hidden unit whose pre-activation lies within one rounding of 0 can
# fall on the other side of the ReLU; a backward then passes or drops
# that unit's whole cotangent, which moves single entries by up to ~10 %
# while the tensor as a whole agrees. Max-abs errors are printed beside.
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The paths phase: largest |loss difference| between a mode's paths over
# their iterations, relative to the first path's first loss.
PATHS_RTOL = 2e-3
# Mode 2: the query at 7-Scenes H/2, rendered at a quarter of that
IMG_H, IMG_W, FOCAL_FULL = 4 * H, 4 * W, 4 * FOCAL
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
# kernel -> (the TPU kernel it replaces, its CUDA source)
_FF, _FR = ("nefes_tpu_torch/csrc/fused_field.cu",
            "nefes_tpu_torch/csrc/fused_render.cu")
KERNELS = {
    "K1 field_fwd_pre": ("nefes_tpu/kernels/fused_field.py:686", _FF),
    "K2 field_bwd_pre": ("nefes_tpu/kernels/fused_field.py:712", _FF),
    "K3 render_fwd_pre": ("nefes_tpu/kernels/fused_render.py:363", _FR),
    "K4 render_bwd_pre": ("nefes_tpu/kernels/fused_render.py:380", _FR),
    "K5 field_fwd": ("nefes_tpu/kernels/fused_field.py:597", _FF),
    "K6 field_bwd": ("nefes_tpu/kernels/fused_field.py:622", _FF),
    "K7 render_fwd": ("nefes_tpu/kernels/fused_render.py:208", _FR),
    "K8 render_bwd": ("nefes_tpu/kernels/fused_render.py:225", _FR),
}


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,check,mode3,mode2,paths,time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2

    from nefes_tpu_torch.kernels import build
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = args.phases.split(",")
    failed: list[str] = []
    state: dict = {}
    kernels = {name: {"name": name, "route": "cuda", "replaces": tpu,
                      "source": src} for name, (tpu, src) in KERNELS.items()}

    def phase(name, fn):
        if name not in phases:
            return
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            log(f"== {name} FAILED")
            failed.append(name)
        log(f"== {name} done in {time.perf_counter() - t0:.1f} s")

    def do_build():
        t0 = time.perf_counter()
        times = build.build_all()
        log(f"built in {time.perf_counter() - t0:.1f} s: {times}")
        for name in build.SOURCES:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    phase("build", do_build)
    if "build" in failed:
        return finish(failed, kernels)

    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    models = {}
    for dt in ("bfloat16", "float32"):
        cfg = ModelConfig(dtype=kf._DTYPES[dt])
        models[dt] = NeFeSModel(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))
    model = models["bfloat16"]
    for m in models.values():
        m.requires_grad_(False)
    gt = torch.from_numpy(look_at()).to(dev)

    def do_check():
        for dt, m in models.items():
            ins = main_path_inputs(m, gt, dev)
            state.setdefault("inputs", {})[dt] = ins
            gen = torch.Generator(device=dev).manual_seed(1)
            cd = kf._DTYPES[dt]
            pc, pf = ins["packed"]
            n_c, n_f = ins["emb_c"].shape[0], ins["emb"].shape[0]
            heads = ((n_f,), (n_f, 3), (n_f, pf.spec.feature_dim))
            g_field = [torch.randn(s, device=dev, generator=gen).to(cd)
                       for s in heads]
            g_raw = [torch.randn(s, device=dev, generator=gen)
                     for s in heads]
            g_sig_c = torch.randn(n_c, device=dev, generator=gen)
            g_ray = torch.randn((ins["z"].shape[0], pf.spec.rgbfeat + 2),
                                device=dev, generator=gen) * 1e-3
            ins.update(g_field=g_field, g_raw=g_raw, g_ray=g_ray)
            pts_c, pts, dirs, z = (ins["pts_c"], ins["pts"], ins["dirs"],
                                   ins["z"])
            # (kernel, mode, wrapper, plain version, call)
            cases = [
                ("K1 field_fwd_pre", "sigma", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pc, False, ins["emb_c"], None)[:1]),
                ("K2 field_bwd_pre", "full", kf.field_bwd_pre,
                 kf.field_bwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"], ins["embd"], *g_field)),
                ("K3 render_fwd_pre", "", kr.render_fwd_pre,
                 kr.render_fwd_pre_plain,
                 lambda f: (f(pf, ins["emb"], ins["embd"], z),)),
                ("K4 render_bwd_pre", "", kr.render_bwd_pre,
                 kr.render_bwd_pre_plain,
                 lambda f: f(pf, ins["emb"], ins["embd"], z, g_ray)),
                ("K5 field_fwd", "sigma", kf.field_fwd, kf.field_fwd_plain,
                 lambda f: f(pc, False, pts_c, None)[:1]),
                ("K5 field_fwd", "full", kf.field_fwd, kf.field_fwd_plain,
                 lambda f: f(pf, True, pts, dirs)),
                ("K6 field_bwd", "sigma", kf.field_bwd, kf.field_bwd_plain,
                 lambda f: f(pc, False, pts_c, None, g_sig_c, None,
                             None)[:1]),
                ("K6 field_bwd", "full", kf.field_bwd, kf.field_bwd_plain,
                 lambda f: f(pf, True, pts, dirs, *g_raw)),
                ("K7 render_fwd", "", kr.render_fwd, kr.render_fwd_plain,
                 lambda f: (f(pf, pts, dirs, z),)),
                ("K8 render_bwd", "", kr.render_bwd, kr.render_bwd_plain,
                 lambda f: f(pf, pts, dirs, z, g_ray)),
            ]
            for name, mode, kern, plain, case in cases:
                got = case(kern)
                torch.cuda.synchronize()
                want = case(plain)
                worst_abs, worst_rel, worst_l2 = 0.0, 0.0, 0.0
                for a, b in zip(got, want):
                    a, b = a.float(), b.float()
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"{name} {dt}: non-finite")
                    err = (a - b).abs().max().item()
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, err / max(
                        b.abs().max().item(), 1e-30))
                    worst_l2 = max(worst_l2, ((a - b).norm() / max(
                        b.norm().item(), 1e-30)).item())
                ok = worst_l2 <= TOL[dt]
                log(f"{name} {mode} {dt}: shapes "
                    f"{[tuple(x.shape) for x in got]} "
                    f"rel_l2 {worst_l2:.3e} (tolerance {TOL[dt]:.0e}) "
                    f"max_abs {worst_abs:.3e} max_abs/max|plain| "
                    f"{worst_rel:.3e} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"{name} {dt} disagrees with plain")
                if dt == "bfloat16":
                    kernels[name]["max_abs_err"] = max(
                        worst_abs, kernels[name].get("max_abs_err", 0.0))
                del got, want
        # the time phase reads the bf16 inputs only
        del state["inputs"]["float32"]
        torch.cuda.empty_cache()

    phase("check", do_check)

    from nefes_tpu_torch.features import DFNet, extract_target_features
    from nefes_tpu_torch.geometry.se3 import learn_pose
    from nefes_tpu_torch.refine import (
        RefineConfig, apply_verification, refine_apr_single,
        refine_pose_single, render_feature_image,
    )
    rcfg = RefineConfig(opt_iter=ITERS, lr_r=0.0087, lr_t=0.01)
    rcfg2 = RefineConfig(opt_iter=ITERS, learning_rate=1e-5)
    base = model.cfg.render_config(n_samples=N_C, n_importance=N_F,
                                   output_transient=False, test_time=True,
                                   perturb=False, remat=False)
    kernel_path = dict(fused=True, fused_need_dw=False)
    cfgs = {
        "render_pre": replace_cfg(base, fused_pre=True, fused_render=True,
                                  **kernel_path),
        "field_pre": replace_cfg(base, fused_pre=True, fused_render=False,
                                 **kernel_path),
        "render_raw": replace_cfg(base, fused_pre=False, fused_render=True,
                                  **kernel_path),
        "fused_raw": replace_cfg(base, fused_pre=False, fused_render=False,
                                 **kernel_path),
        "unfused": base,
    }
    # the kernels each path must launch (and no other)
    path_kernels = {
        "render_pre": ("K1 field_fwd_pre", "K3 render_fwd_pre",
                       "K4 render_bwd_pre"),
        "field_pre": ("K1 field_fwd_pre", "K2 field_bwd_pre"),
        "render_raw": ("K5 field_fwd", "K7 render_fwd", "K8 render_bwd"),
        "fused_raw": ("K5 field_fwd", "K6 field_bwd"),
        "unfused": (),
    }
    hist = torch.zeros(10, device=dev)
    ws_vec = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    init = learn_pose(torch.tensor([0.02, -0.03, 0.01], device=dev),
                      torch.tensor([0.05, -0.04, 0.03], device=dev),
                      gt)[:3, :4]
    with torch.no_grad():
        _, target = render_feature_image(model, gt, hist, (H, W, FOCAL),
                                         NEAR, FAR, base)
    all_kernels = (kf.field_fwd_pre, kf.field_bwd_pre, kr.render_fwd_pre,
                   kr.render_bwd_pre, kf.field_fwd, kf.field_bwd,
                   kr.render_fwd, kr.render_bwd)

    def counted(cfg_name, fn):
        """Run fn with every launch count set to 0 just before it; returns
        (its result, seconds, the counts), and fails if the path did not
        launch exactly its own kernels."""
        for k in all_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: k.launches for n, k in zip(KERNELS, all_kernels)}
        ran = {n for n, c in counts.items() if c}
        if ran != set(path_kernels[cfg_name]):
            raise AssertionError(f"{cfg_name} launched {sorted(ran)}, "
                                 f"expected {path_kernels[cfg_name]}")
        return out, dt, {n: c for n, c in counts.items() if c}

    def peak_mib(held: int) -> str:
        peak = torch.cuda.max_memory_allocated()
        return (f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB "
                f"above the {held / 2**20:.1f} MiB held before the frame")

    def refine3(cfg_name, iters):
        (refined, losses), dt, counts = counted(cfg_name, lambda: (
            refine_pose_single(model, init, target, hist, ws_vec,
                               (H, W, FOCAL), NEAR, FAR, cfgs[cfg_name],
                               replace_cfg(rcfg, opt_iter=iters))))
        return refined, losses.cpu(), dt, counts

    def mode2_inputs():
        """The f32 DFNet (seed 1), aimed at the scene: fc_pose's weight
        scaled down and its bias the perturbed start pose of mode 3, so
        the first render sees what mode 3's does; the query, 240x320
        noise (seed 3); its level-0 target features at full size."""
        if "mode2_inputs" not in state:
            dfnet = DFNet(output_dim=model.cfg.feature_dim, device=dev,
                          generator=torch.Generator().manual_seed(1))
            dfnet.requires_grad_(False)
            with torch.no_grad():
                dfnet.fc_pose.weight.mul_(1e-2)
                dfnet.fc_pose.bias.copy_(init.reshape(12))
                image = torch.rand((IMG_H, IMG_W, 3),
                                   generator=torch.Generator().manual_seed(3)
                                   ).to(dev)
                target2 = extract_target_features(dfnet, image[None], IMG_H,
                                                  IMG_W)[0]
            state["mode2_inputs"] = (dfnet, image, target2)
        return state["mode2_inputs"]

    def refine2(cfg_name, iters):
        dfnet, image, target2 = mode2_inputs()
        out, dt, counts = counted(cfg_name, lambda: refine_apr_single(
            model, dfnet, image, target2, hist, ws_vec, (H, W, FOCAL),
            (IMG_H, IMG_W, FOCAL_FULL), NEAR, FAR, cfgs[cfg_name],
            replace_cfg(rcfg2, opt_iter=iters)))
        return out, out["losses"].cpu(), dt, counts

    def do_mode3():
        refine3("render_pre", 2)                    # warm: build, caches
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        refined, losses, dt, counts = refine3("render_pre", ITERS)
        peak = peak_mib(held)
        log(f"mode3 render_pre: {dt:.3f} s/frame ({ITERS} iters, "
            f"{H}x{W} rays, {N_C}+{N_F} samples, bf16)")
        log(f"  loss first {losses[0]:.6f} last {losses[-1]:.6f}")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        log(f"  refined pose {refined.cpu().numpy().round(5).tolist()}")
        if not (torch.isfinite(losses).all() and refined.shape == (3, 4)
                and torch.isfinite(refined).all()):
            raise AssertionError("non-finite mode-3 result")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall")
        for name in path_kernels["render_pre"]:
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "mode3 render_pre"

    phase("mode3", do_mode3)

    def do_mode2():
        refine2("render_raw", ITERS)                # warm-up frame
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out, losses, dt, counts = refine2("render_raw", ITERS)
        peak = peak_mib(held)
        final = apply_verification(out, "psnr_ssim")
        retreat = bool(out["end_psnr"] < out["init_psnr"]
                       or out["end_ssim"] < out["init_ssim"])
        moved = (out["refined_pose"] - out["initial_pose"]).abs().max()
        log(f"mode2 render_raw: {dt:.3f} s/frame ({ITERS} iters, DFNet f32 "
            f"on {IMG_H}x{IMG_W}, {H}x{W} rays, {N_C}+{N_F} samples, "
            f"NeFeS bf16)")
        log(f"  loss first {losses[0]:.6f} last {losses[-1]:.6f}")
        log(f"  psnr init {out['init_psnr']:.4f} end {out['end_psnr']:.4f}; "
            f"ssim init {out['init_ssim']:.6f} end {out['end_ssim']:.6f}")
        log(f"  verification psnr_ssim: "
            f"{'retreat to the initial pose' if retreat else 'keep the refined pose'}"
            f"; the APR moved the pose by {moved:.3e} (max abs)")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        if not (torch.isfinite(losses).all()
                and torch.isfinite(out["refined_pose"]).all()
                and torch.isfinite(final).all()):
            raise AssertionError("non-finite mode-2 result")
        if not torch.equal(final, out["initial_pose"] if retreat
                           else out["refined_pose"]):
            raise AssertionError("apply_verification chose the wrong pose")
        for name in path_kernels["render_raw"]:
            if counts[name] != ITERS:
                raise AssertionError(f"{name}: {counts[name]} launches in "
                                     f"{ITERS} iterations")
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "mode2 render_raw"
        _, losses_p, dt_p, counts_p = refine2("render_pre", ITERS)
        log(f"mode2 render_pre: {dt_p:.3f} s/frame, launches {counts_p}; "
            f"render_raw / render_pre = {dt / dt_p:.3f}")

    phase("mode2", do_mode2)

    def do_paths():
        n_it = 5
        modes = (("mode3", ("render_pre", "field_pre", "unfused",
                            "render_raw", "fused_raw"), refine3),
                 ("mode2", ("render_raw", "fused_raw", "render_pre",
                            "unfused"), refine2))
        for mode, names, run in modes:
            runs = {}
            for name in names:
                _, losses, dt, counts = run(name, n_it)
                runs[name] = losses
                per_frame = {k: c * ITERS // n_it for k, c in counts.items()}
                log(f"{mode} {name}: {n_it} iters in {dt:.3f} s, losses "
                    f"{[round(float(x), 6) for x in losses]}, launches "
                    f"{counts} ({per_frame} per {ITERS}-iteration frame)")
                for k in ("K2 field_bwd_pre", "K6 field_bwd"):
                    if k in counts and "launches" not in kernels[k]:
                        kernels[k]["launches"] = counts[k]
                        kernels[k]["path"] = f"{mode} {name}"
            # Mode 3's paths agreed to 3.5e-6 on an H100 with losses from
            # 5.5e-3 (PERF.md); the limit is 2e-3 of the first loss, ~3x
            # that.
            tol = PATHS_RTOL * float(runs[names[0]][0])
            for name in names[1:]:
                diff = (runs[name] - runs[names[0]]).abs().max().item()
                log(f"{mode}: max |loss({name}) - loss({names[0]})| = "
                    f"{diff:.3e} (tolerance {tol:.3e} = {PATHS_RTOL:g} x "
                    f"first loss)")
                if not diff <= tol:
                    raise AssertionError(f"{mode} {name} losses disagree")

    phase("paths", do_paths)

    def do_time():
        if "inputs" not in state:
            raise RuntimeError("the time phase needs the check phase")
        ins = state["inputs"]["bfloat16"]
        pc, pf = ins["packed"]
        emb_c, emb, embd, z = ins["emb_c"], ins["emb"], ins["embd"], ins["z"]
        pts_c, pts, dirs = ins["pts_c"], ins["pts"], ins["dirs"]
        g_field, g_raw, g_ray = ins["g_field"], ins["g_raw"], ins["g_ray"]
        n_c, n_f, R = emb_c.shape[0], emb.shape[0], z.shape[0]
        sp = pf.spec
        fl, el = tower_flops(sp), embed_ops(sp)
        b2, b4 = 2, 4   # bytes of a bf16 and of an f32 value
        ray_out = R * (sp.rgbfeat + 2) * b4
        # name: (call, wrapper, plain version, yardstick, bf16 matmul
        # FLOPs, f32 elementwise operations, bytes besides the weights)
        rows = {
            "K1 field_fwd_pre": (
                lambda f: f(pc, False, emb_c, None), kf.field_fwd_pre,
                kf.field_fwd_pre_plain,
                lambda: chain(pc, False, emb_c, None, False),
                n_c * fl["K1"], 0, n_c * (sp.emb_xyz + 1) * b2),
            "K2 field_bwd_pre": (
                lambda f: f(pf, True, emb, embd, *g_field),
                kf.field_bwd_pre, kf.field_bwd_pre_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K2"], 0,
                n_f * (2 * (sp.emb_xyz + sp.emb_dir) + sp.rgbfeat + 1) * b2),
            "K3 render_fwd_pre": (
                lambda f: f(pf, emb, embd, z), kr.render_fwd_pre,
                kr.render_fwd_pre_plain,
                lambda: chain(pf, True, emb, embd, False),
                n_f * fl["K3"], 0,
                n_f * (sp.emb_xyz + sp.emb_dir) * b2 + n_f * b4 + ray_out),
            "K4 render_bwd_pre": (
                lambda f: f(pf, emb, embd, z, g_ray), kr.render_bwd_pre,
                kr.render_bwd_pre_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K4"], 0,
                2 * n_f * (sp.emb_xyz + sp.emb_dir) * b2 + 2 * n_f * b4
                + ray_out),
            "K5 field_fwd": (
                lambda f: f(pc, False, pts_c, None), kf.field_fwd,
                kf.field_fwd_plain,
                lambda: chain(pc, False, emb_c, None, False),
                n_c * fl["K1"], n_c * el["xyz_fwd"], n_c * (3 + 1) * b4),
            "K6 field_bwd": (
                lambda f: f(pf, True, pts, dirs, *g_raw), kf.field_bwd,
                kf.field_bwd_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K2"], n_f * (el["fwd"] + el["bwd"]),
                n_f * (4 * 3 + sp.rgbfeat + 1) * b4),
            "K7 render_fwd": (
                lambda f: f(pf, pts, dirs, z), kr.render_fwd,
                kr.render_fwd_plain,
                lambda: chain(pf, True, emb, embd, False),
                n_f * fl["K3"], n_f * el["fwd"],
                n_f * (2 * 3 + 1) * b4 + ray_out),
            "K8 render_bwd": (
                lambda f: f(pf, pts, dirs, z, g_ray), kr.render_bwd,
                kr.render_bwd_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K4"], n_f * (el["fwd"] + el["bwd"]),
                2 * n_f * (2 * 3 + 1) * b4 + ray_out),
        }
        weight_bytes = pf.w.numel() * b2 + pf.b.numel() * b4
        for name, (case, kern, plain, lib_fn, flops, ew, nbytes) in \
                rows.items():
            saved = kern.launches
            ms = time_ms(lambda: case(kern))
            kern.launches = saved      # timing launches are not the path's
            plain_ms = time_ms(lambda: case(plain), reps=3)
            lib_ms = time_ms(lib_fn, reps=3)
            nbytes += weight_bytes
            t_ops = (flops / PEAK_BF16_FLOPS + ew / PEAK_F32_FLOPS) * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            kernels[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops + ew, bytes=nbytes)
            log(f"{name}: {ms:.3f} ms (bound {max(t_ops, t_bytes):.4f} ms "
                f"by {kernels[name]['bound_by']}: {flops / 1e9:.1f} GFLOP "
                f"bf16 + {ew / 1e9:.3f} G f32 ops, {nbytes / 1e6:.1f} MB; "
                f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
                f"bf16 matmul chain {lib_ms:.3f} ms")

    phase("time", do_time)
    return finish(failed, kernels)


def finish(failed, kernels) -> int:
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [{k: v.get(k) for k in keys} | {"path": v.get("path")}
            for v in kernels.values()]
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def replace_cfg(cfg, **kw):
    from dataclasses import replace
    return replace(cfg, **kw)


def look_at() -> np.ndarray:
    from nefes_tpu_torch.data.synthetic import look_at_pose
    return look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))


def main_path_inputs(model, pose, dev) -> dict:
    """The kernels' inputs at the true pose, made as the renderer makes
    them: coarse points (H·W·64, 3) and embeddings (H·W·64, 63), fine
    points and per-sample directions (H·W·128, 3) with their embeddings
    (63 and 27), and fine z (H·W, 128); points and directions in f32,
    embeddings in the model's pack dtype."""
    from nefes_tpu_torch.fields.embedder import embed
    from nefes_tpu_torch.geometry.rays import get_rays
    from nefes_tpu_torch.kernels.fused_field import field_fwd_pre_plain
    from nefes_tpu_torch.render.compositor import composite
    from nefes_tpu_torch.render.sampling import (
        hierarchical_samples, stratified_samples,
    )
    cfg = model.cfg
    cd = cfg.dtype
    packed = model.pack_fused()
    with torch.no_grad():
        ro, rd = get_rays(H, W, FOCAL, pose[:3, :4])
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        R = ro.shape[0]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        z = stratified_samples(None, R, N_C, NEAR, FAR, perturb=False,
                               device=dev)
        pts = ro[:, None] + rd[:, None] * z[..., None]
        emb_c = embed(pts, cfg.xyz_embed).to(cd).reshape(R * N_C, -1)
        sigma = field_fwd_pre_plain(packed[0], False, emb_c, None)[0]
        w = composite({"static_sigma": sigma.reshape(R, N_C)}, z,
                      sigma_only=True, test_time=True)["weights"]
        zf = hierarchical_samples(None, z, w, N_F, det=True)
        S = zf.shape[1]
        pf = ro[:, None] + rd[:, None] * zf[..., None]
        emb = embed(pf, cfg.xyz_embed).to(cd).reshape(R * S, -1)
        embd = embed(vd[:, None].expand(R, S, 3), cfg.dir_embed).to(
            cd).reshape(R * S, -1)
        dirs = vd[:, None].expand(R, S, 3).reshape(R * S, 3)
    return dict(packed=packed, emb_c=emb_c.contiguous(),
                emb=emb.contiguous(), embd=embd.contiguous(),
                z=zf.contiguous(), pts_c=pts.reshape(-1, 3).contiguous(),
                pts=pf.reshape(-1, 3).contiguous(), dirs=dirs.contiguous())


def tower_flops(spec) -> dict:
    """Matrix-product operations per sample (2 per multiply-add) that each
    kernel's function needs. K1: the trunk and the sigma head. K3: the
    whole forward, with the dir layer and the 3+F rgb/feature head. The
    backwards recompute the forward without the head (K2), or with only
    the 3 rgb columns that the composite's weights need (K4), then
    backprop through the whole tower to the inputs, which takes as many
    products as the whole forward. K5-K8 do the products of K1 (sigma
    mode), K2, K3 and K4, plus the elementwise embedding (embed_ops)."""
    E, Ed, Wd, Hd, C = (spec.emb_xyz, spec.emb_dir, spec.width, spec.half,
                        spec.rgbfeat)
    trunk = E * Wd + (spec.depth - 1) * Wd * Wd + Wd
    trunk += sum(E * Wd for i in spec.skips if 0 < i < spec.depth)
    body = trunk + Wd * Wd + (Wd + Ed) * Hd
    full = body + Hd * C
    return {"K1": 2 * trunk, "K2": 2 * (body + full), "K3": 2 * full,
            "K4": 2 * (body + Hd * 3 + full)}


def embed_ops(spec) -> dict:
    """f32 elementwise operations per sample of the raw kernels'
    embedding, each sin or cos counted as one: forward 3 phases and 6
    sin/cos per band and coordinate (x only: "xyz_fwd"; x and the
    direction: "fwd"); the chain rule back to the inputs, per band and
    coordinate 2 sin/cos, 3 products and 2 sums ("bwd")."""
    nx, nd = spec.n_freqs_xyz, spec.n_freqs_dir
    return {"xyz_fwd": 3 * 3 * nx, "fwd": 3 * 3 * (nx + nd),
            "bwd": 3 * 7 * (nx + nd)}


def chain(p, full, emb, embd, backward):
    """Yardstick: the tower's matmuls as a plain bf16 torch.matmul chain
    (cuBLAS), forward and, for a backward, the input-gradient products."""
    w, spec = p.weights, p.spec
    h, masks = emb, []
    for i in range(spec.depth):
        z = h @ w[f"l{i}_wh" if i else "l0_we"]
        if i and i in spec.skips:
            z = z + emb @ w[f"l{i}_we"]
        h = torch.relu(z)
        masks.append(h)
    out = [h @ w["sig_w"]]
    if full:
        fin = h @ w["fin_w"]
        de = torch.relu(fin @ w["dir_wh"] + embd @ w["dir_wd"])
        out.append(de @ w["rgb_w"])
    if not backward:
        return out
    g = out[1] @ w["rgb_w"].t()
    g_fin = g @ w["dir_wh"].t()
    g_embd = g @ w["dir_wd"].t()
    dh = g_fin @ w["fin_w"].t() + out[0] @ w["sig_w"].t()
    d_emb = 0
    for i in range(spec.depth - 1, -1, -1):
        dz = dh * (masks[i] > 0)
        if i == 0:
            d_emb = d_emb + dz @ w["l0_we"].t()
        else:
            dh = dz @ w[f"l{i}_wh"].t()
            if i in spec.skips:
                d_emb = d_emb + dz @ w[f"l{i}_we"].t()
    return d_emb, g_embd


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` timed calls (CUDA events) after two warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


if __name__ == "__main__":
    sys.exit(main())
