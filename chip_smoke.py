"""On-card smoke run of nefes_tpu_torch on one NVIDIA GPU (written for the
H100: the kernels build for sm_90a).

    python3 chip_smoke.py [--phases build,check,mode3,mode2,paths,train,time,micro,probe,profile]
        [--parent DIR]

Phases:
  build  compile the CUDA kernels from csrc/ (nvcc, one process per
         source, in parallel) into nefes_tpu_torch/_build/; with --parent
         also DIR's fused_render.cu and fused_field.cu, in parallel; each
         kernel's ptxas registers and stack frame; the render kernels'
         shared memory a block, blocks per SM and the backward's global
         scratch a ray; K1/K5's shared memory a block and blocks per SM in
         sigma and full mode (coarse tower) and transient mode (fine
         tower); K2/K6's likewise (the warp path in every mode)
  check  K1-K8 against their plain PyTorch versions on the card, at the
         shapes of the refinement's main path, in bf16 and f32 (K1/K5 in
         sigma mode, without dirs, and in full mode, also at a sample
         count that is not a multiple of 128; K3/K4/K7/K8
         also at 64 rays of a depth-4, 16-feature field, and at full width
         at 256, 384 and 1024 samples a ray); and the
         training variants at the training shapes: K1/K5 in transient
         mode (also at the fine pass's samples less RAGGED; every head,
         the five transient ones each; two calls and the persistent grid
         against one block per block tile bit for bit the same), K2/K6
         with weight gradients in sigma, full and transient
         mode (every dW and bias gradient checked) and frozen in
         transient mode, two calls of each
         bit for bit the same, and the dW kernel (field_dw) alone on the
         operands of the first chunk of the fine and the coarse training
         pass against field_dw_plain; K2/K6 (the warp path) in sigma and
         full mode at the coarse training shape and in transient mode at
         the fine one, frozen and with dW: two calls, and the persistent
         grid against one block per block tile, bit for bit the same, and
         with dW over chunks that end in the middle of a block tile
         against the plain version
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
  train  field training at full width (NeFeS D8/W128/F128 in bf16, stage
         1, 4 images x 1536 random rays of a 60x80 render, 64+64 samples,
         perturbed, NeRF-W transient heads): 2 warm-up and 20 timed steps
         through the raw-input kernels with weight gradients (fused=True,
         fused_pre=False, fused_need_dw=True: K5, K6 +dW once a chunk of
         rows, each chunk followed by the dW kernel), s/step, rays/s,
         losses, peak memory, launch counts; 3 steps of each path (train_raw,
         train_pre through K1/K2, unfused) from one initial state, in bf16
         and f32, whose losses and parameters must agree; 3 stage-2 patch
         steps through the kernels (finite loss, BN running stats move)
  time   each kernel's time (CUDA events, median) beside its bound, its
         plain version's time and a bf16 torch.matmul chain over the same
         tower as a yardstick; the training variants at the fine training
         shape, and the coarse pass's training launches. K1 and K5, in
         sigma mode (main path) and transient mode (training's fine
         pass), in turns with themselves on one block per block tile
         instead of the persistent grid; with --parent DIR (an earlier
         tree, unpacked with git archive into a git-ignored directory)
         also DIR's, and the
         render kernels K3, K4, K7 and K8, the training backwards K2
         and K6 in transient mode (fine pass), with dW and frozen, and K2
         and K6 in full mode, frozen at the refinement's fine pass and K6
         with dW at the coarse training pass (this tree's backwards also
         on one block per block tile), of DIR and of this tree in turns
         on the same inputs, each of DIR's checked against its plain
         version first; the dW kernel alone on the fine pass's first
         chunk
  micro  the probe's kernelmicro (nefes_tpu_torch/runtime/probe.py) at the
         fine-pass shape, N = 614,400 rows: K9 (bare bf16 8-layer chain)
         at tiles 64 (micro.cu's sub-tile), 512, 2048, 8192, K10 (2 and
         4 sub-tiles interleaved),
         K11 (the sin/cos embedding alone) at each tile, K12 (square
         chains of width 128 and 256), then K5, K1 and K1 + K2, each
         timed beside its bound, its plain version and a bf16
         torch.matmul chain; then K9-K12 against their plain versions at
         every tile and width (relative L2; K11 bit for bit; K10 equal to
         K9)
  probe  the probe's kernel (K5/K6 against the plain field in f32 and
         bf16, K7/K8 against the plain fine pass and compositor) and perf
         (the pieces of a mode-3 iteration through K1, K3, K4; one timed
         50-iteration refine) commands once
  profile torch.profiler over 3 train_raw steps and 5 iterations of mode 3
         and mode 2: the device's busy share of the wall time, device
         time per kernel

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
from pathlib import Path

import numpy as np
import torch

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
# The train phase: B images x N_rand rays per step (bench.py's
# train_throughput leg), timed steps, and the parameters of the three
# paths after PATH_STEPS steps from one state, relative L2 ||p_path -
# p_train_raw|| / ||p_train_raw||. On an H100 the f32 paths agreed to
# 4.2e-7 (sums in another order only), bf16 to 1.3e-4: bf16 also rounds
# in other places (heads in bf16 on K1/K2, f32 on K5/K6), and Adam's
# first steps move every weight by about lr whatever its gradient's size,
# so a gradient near 0 whose sign differs moves a weight by up to 2 lr
# the other way. The limits are about 10x those.
TRAIN_B, N_RAND, TRAIN_STEPS, PATH_STEPS, TRAIN_LR = 4, 1536, 20, 3, 5e-4
PARAM_TOL = {"float32": 5e-6, "bfloat16": 1e-3}
# Mode 2: the query at 7-Scenes H/2, rendered at a quarter of that
IMG_H, IMG_W, FOCAL_FULL = 4 * H, 4 * W, 4 * FOCAL
# The probe phase: K5's bf16 max-abs error from the plain f32 field within
# PROBE_BAND times the plain bf16 field's, and the fused render's rgb
# within PROBE_RGB_TOL (max-abs) of the unfused fine pass + compositor. On
# an H100 the ratios read 0.06-0.79 and the rgb 2.6e-4 (PERF.md).
PROBE_BAND, PROBE_RGB_TOL = 4.0, 3e-3
# The first version of K1/K5, K2/K6 (frozen, full mode; in transient mode
# at the fine training pass with dW and frozen) and K3/K4/K7/K8 (f32
# tiles, weights through L1; the render kernels' composite in one thread,
# K4/K8 two tower forwards per sample), at the time phase's shape:
# PERF.md's times, an H100 80GB HBM3 at 700 W; the time phase prints them
# beside the new ones.
EARLIER_MS = {"K1 field_fwd_pre": 3.589, "K5 field_fwd": 3.739,
              "K2 field_bwd_pre": 28.915, "K6 field_bwd": 29.821,
              "K3 render_fwd_pre": 16.172, "K4 render_bwd_pre": 42.796,
              "K7 render_fwd": 14.576, "K8 render_bwd": 43.761,
              "K1 field_fwd_pre transient": 20.005,
              "K5 field_fwd transient": 20.756,
              "K2 field_bwd_pre +dW": 50.784, "K6 field_bwd +dW": 51.629,
              "K2 field_bwd_pre transient": 42.3,
              "K6 field_bwd transient": 43.3}
# The check phase's render kernels at full width: samples a ray (the
# backward's per-sample state past a block's shared memory from 205 in
# f32 and 270 in bf16) and rays
WIDE_S, WIDE_R = (256, 384, 1024), 64
# The check phase's K1/K5 also at the main path's sample counts less this,
# which is not a multiple of the 128-sample block tile
RAGGED = 37
# the libraries of an earlier tree (--parent) that the time phase times
PARENT_LIBS = ("fused_render", "fused_field")
# the field kernels' modes by number (csrc/tower.cuh Mode)
MODES = ("sigma", "full", "transient")
# kernel -> (the TPU kernel it replaces, its CUDA source)
_FF, _FR, _MC = ("nefes_tpu_torch/csrc/fused_field.cu",
                 "nefes_tpu_torch/csrc/fused_render.cu",
                 "nefes_tpu_torch/csrc/micro.cu")
KERNELS = {
    "K1 field_fwd_pre": ("nefes_tpu/kernels/fused_field.py:686", _FF),
    "K2 field_bwd_pre": ("nefes_tpu/kernels/fused_field.py:712", _FF),
    "K3 render_fwd_pre": ("nefes_tpu/kernels/fused_render.py:363", _FR),
    "K4 render_bwd_pre": ("nefes_tpu/kernels/fused_render.py:380", _FR),
    "K5 field_fwd": ("nefes_tpu/kernels/fused_field.py:597", _FF),
    "K6 field_bwd": ("nefes_tpu/kernels/fused_field.py:622", _FF),
    "K7 render_fwd": ("nefes_tpu/kernels/fused_render.py:208", _FR),
    "K8 render_bwd": ("nefes_tpu/kernels/fused_render.py:225", _FR),
    # the training variants of K1/K5 (transient mode) and K2/K6 (need_dw)
    "K1 field_fwd_pre transient": ("nefes_tpu/kernels/fused_field.py:686",
                                   _FF),
    "K2 field_bwd_pre +dW": ("nefes_tpu/kernels/fused_field.py:712", _FF),
    "K5 field_fwd transient": ("nefes_tpu/kernels/fused_field.py:597", _FF),
    "K6 field_bwd +dW": ("nefes_tpu/kernels/fused_field.py:622", _FF),
    # the weight gradients of K2/K6 +dW (_mlp_backward's dmat, need_dw)
    "K2/K6 field_dw": ("nefes_tpu/kernels/fused_field.py:477",
                       "nefes_tpu_torch/csrc/field_dw.cuh"),
    # the probe's micro-benchmarks (cmd_kernelmicro's pl.pallas_call sites)
    "K9 chain": ("runtime/probe.py:1264", _MC),
    "K10 chain_interleaved": ("runtime/probe.py:1298", _MC),
    "K11 embed_micro": ("runtime/probe.py:1340", _MC),
    "K12 chain_sq": ("runtime/probe.py:1374", _MC),
}


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,check,mode3,mode2,paths,train,time,"
                    "micro,probe,profile")
    ap.add_argument("--parent", default=None,
                    help="an earlier tree whose K1, K5 and render kernels "
                    "the time phase times beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2

    from nefes_tpu_torch.kernels import build
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr
    from nefes_tpu_torch.kernels import micro as km
    from nefes_tpu_torch.runtime import probe

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

    parent = ({} if args.parent is None else
              dict(build_dir=build.BUILD_DIR / "parent",
                   csrc=Path(args.parent) / "nefes_tpu_torch" / "csrc"))

    def do_build():
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            jobs = [ex.submit(build.build_all)]
            if parent:
                jobs.append(ex.submit(build.build_all, names=PARENT_LIBS,
                                      **parent))
            times = [j.result() for j in jobs]
        log(f"built in {time.perf_counter() - t0:.1f} s: {times}")
        logs = [(name, {}) for name in build.SOURCES]
        if parent:
            logs += [(name, parent) for name in PARENT_LIBS]
        for name, where in logs:
            entry = ""
            for line in build.build_log(name, **where).splitlines():
                if "Compiling entry function" in line:
                    entry = kernel_label(line)
                elif "registers" in line or "spill" in line:
                    log(f"  ptxas {'parent ' if where else ''}{name} "
                        f"{entry}: {line.strip()}")
        # the render kernels at full width (D8/W128/F128), at the main
        # path's 128 samples and the check phase's: dynamic shared memory
        # of a block, blocks per SM, the backward's global scratch a ray
        from nefes_tpu_torch.train.model import ModelConfig
        lib = build.library("fused_render")
        dims = kf.dims(kf.FieldSpec.from_model(ModelConfig(), "fine"))
        for dt, code in (("bf16", 1), ("f32", 0)):
            for S in (N_C + N_F, *WIDE_S):
                for pair, bwd in (("K3/K7 render_fwd", 0),
                                  ("K4/K8 render_bwd", 1)):
                    blocks = [lib.nefes_render_blocks_per_sm(
                        code, bwd, raw, S, *dims) for raw in (0, 1)]
                    scratch = lib.nefes_render_bwd_scratch_bytes(code, S,
                                                                 *dims)
                    scratch = f", scratch {scratch} B a ray" if bwd else ""
                    log(f"{pair} {dt} at {S} samples: "
                        f"{lib.nefes_render_smem_bytes(code, bwd, S, *dims)}"
                        f" B of shared memory a block, blocks per SM "
                        f"{blocks[0]} / {blocks[1]} (pre / raw){scratch}")
        # the field forward K1/K5 by mode: sigma and full mode on the
        # coarse tower, transient mode on the fine one
        flib = build.library("fused_field")
        for dt, code in (("bf16", 1), ("f32", 0)):
            for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
                fdims = kf.dims(kf.FieldSpec.from_model(
                    ModelConfig(), "fine" if mode == kf.TRANSIENT
                    else "coarse"))
                blocks = [flib.nefes_field_blocks_per_sm(code, mode, raw,
                                                         *fdims)
                          for raw in (0, 1)]
                log(f"K1/K5 field_fwd {MODES[mode]} {dt}: "
                    f"{flib.nefes_field_smem_bytes(code, mode, *fdims)} B "
                    f"of shared memory a block, blocks per SM {blocks[0]} "
                    f"/ {blocks[1]} (pre / raw)")
            # the backward K2/K6's warp path: sigma and full mode on the
            # coarse tower, transient mode on the fine one
            for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
                bdims = kf.dims(kf.FieldSpec.from_model(
                    ModelConfig(), "fine" if mode == kf.TRANSIENT
                    else "coarse"))
                blocks = [flib.nefes_field_bwd_blocks_per_sm(code, mode, raw,
                                                             *bdims)
                          for raw in (0, 1)]
                log(f"K2/K6 field_bwd {MODES[mode]} {dt}: "
                    f"{flib.nefes_field_bwd_smem_bytes(code, mode, *bdims)} "
                    f"B of shared memory a block, blocks per SM {blocks[0]} "
                    f"/ {blocks[1]} (pre / raw)")

    phase("build", do_build)
    if "build" in failed:
        return finish(failed, kernels, smi)

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

    def compare(name, mode, dt, got, want, names=None):
        """Kernel outputs against the plain version's: relative L2 per
        output (None pairs skipped), max-abs beside; raises past TOL."""
        worst_abs, worst_l2, parts = 0.0, 0.0, []
        pairs = [(i, a, b) for i, (a, b) in enumerate(zip(got, want))
                 if b is not None]
        for i, a, b in pairs:
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {dt}: non-finite")
            err = (a - b).abs().max().item()
            l2 = ((a - b).norm() / max(b.norm().item(), 1e-30)).item()
            worst_abs, worst_l2 = max(worst_abs, err), max(worst_l2, l2)
            if names:
                parts.append(f"{names[i]} {l2:.3e}/{err:.3e}")
        ok = worst_l2 <= TOL[dt]
        log(f"{name} {mode} {dt}: shapes "
            f"{[tuple(a.shape) for _, a, _ in pairs]} rel_l2 {worst_l2:.3e} "
            f"(tolerance {TOL[dt]:.0e}) max_abs {worst_abs:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if parts:
            log(f"  per output rel_l2/max_abs: {', '.join(parts)}")
        if not ok:
            raise AssertionError(f"{name} {dt} disagrees with plain")
        if dt == "bfloat16":
            kernels[name]["max_abs_err"] = max(
                worst_abs, kernels[name].get("max_abs_err", 0.0))

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
            # sample counts that are not a multiple of a block tile
            rc, rf = n_c - RAGGED, n_f - RAGGED
            # (kernel, mode, wrapper, plain version, call)
            cases = [
                ("K1 field_fwd_pre", "sigma", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pc, False, ins["emb_c"], None)[:1]),
                ("K1 field_fwd_pre", "full", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"], ins["embd"])),
                ("K1 field_fwd_pre", f"sigma N={rc}", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pc, False, ins["emb_c"][:rc], None)[:1]),
                ("K1 field_fwd_pre", f"full N={rf}", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"][:rf], ins["embd"][:rf])),
                ("K5 field_fwd", f"sigma N={rc}", kf.field_fwd,
                 kf.field_fwd_plain,
                 lambda f: f(pc, False, pts_c[:rc], None)[:1]),
                ("K5 field_fwd", f"full N={rf}", kf.field_fwd,
                 kf.field_fwd_plain,
                 lambda f: f(pf, True, pts[:rf], dirs[:rf])),
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
                compare(name, mode, dt, got, case(plain))
                del got
            check_training(dt, m)
            check_render_small(dt)
            check_render_wide(dt)
        # the time phase reads the bf16 inputs only
        del state["inputs"]["float32"], state["train_inputs"]["float32"]
        torch.cuda.empty_cache()

    def render_cases(mode, dt, pf, R, S, gen):
        """K3/K4/K7/K8 against their plain versions on R rays of S random
        samples (pre-embedded rows, points at the scale of a scene)."""
        sp, cd = pf.spec, kf._DTYPES[dt]
        emb = torch.randn((R * S, sp.emb_xyz), device=dev, generator=gen)
        embd = torch.randn((R * S, sp.emb_dir), device=dev, generator=gen)
        z = torch.sort(torch.rand((R, S), device=dev, generator=gen) * 4,
                       1).values
        pts = torch.randn((R * S, 3), device=dev, generator=gen) * 1.5
        dirs = torch.nn.functional.normalize(
            torch.randn((R * S, 3), device=dev, generator=gen), dim=-1)
        g = torch.randn((R, sp.rgbfeat + 2), device=dev, generator=gen)
        for (kfwd, kbwd), x, xd, fns in (
                (("K3 render_fwd_pre", "K4 render_bwd_pre"), emb.to(cd),
                 embd.to(cd), (kr.render_fwd_pre, kr.render_fwd_pre_plain,
                               kr.render_bwd_pre, kr.render_bwd_pre_plain)),
                (("K7 render_fwd", "K8 render_bwd"), pts, dirs,
                 (kr.render_fwd, kr.render_fwd_plain, kr.render_bwd,
                  kr.render_bwd_plain))):
            fwd, fwd_plain, bwd, bwd_plain = fns
            compare(kfwd, mode, dt, (fwd(pf, x, xd, z),),
                    (fwd_plain(pf, x, xd, z),))
            compare(kbwd, mode, dt, bwd(pf, x, xd, z, g),
                    bwd_plain(pf, x, xd, z, g))

    def check_render_small(dt):
        """K3/K4/K7/K8 at other dims (depth 4, skip at 2, 16 features; the
        card test's model) on 64 rays x 128 samples of random inputs."""
        cfg = ModelConfig(depth=4, width=128, feature_dim=16, skips=(2,),
                          dtype=kf._DTYPES[dt])
        small = NeFeSModel(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            pf = small.pack_fused()[1]
        render_cases("D4/F16 R=64", dt, pf, 64, N_C + N_F,
                     torch.Generator(device=dev).manual_seed(5))

    def check_render_wide(dt):
        """K3/K4/K7/K8 at full width on WIDE_R rays of each WIDE_S samples
        a ray: the forward's transmittance carried over block tiles, the
        backward's per-sample state in its global scratch."""
        pf = state["inputs"][dt]["packed"][1]
        gen = torch.Generator(device=dev).manual_seed(6)
        for S in WIDE_S:
            render_cases(f"S={S} R={WIDE_R}", dt, pf, WIDE_R, S, gen)
            torch.cuda.empty_cache()

    def check_training(dt, m):
        """The training variants at the training shapes: K1/K5 transient
        forward (fine pass), K2/K6 with dW in sigma and full mode (coarse
        pass) and transient mode (fine pass), and frozen in transient
        mode."""
        with torch.no_grad():
            tr = train_path_inputs(m, dev)
        state.setdefault("train_inputs", {})[dt] = tr
        gen = torch.Generator(device=dev).manual_seed(2)
        cd = kf._DTYPES[dt]
        pc, pf = tr["packed"]
        F = pf.spec.feature_dim
        n_c, n_f = tr["pts_c"].shape[0], tr["pts"].shape[0]
        log(f"training shapes: coarse {n_c} samples, fine {n_f}")

        def cots(n, hd):
            return [torch.randn(s, device=dev, generator=gen).to(hd)
                    for s in ((n,), (n, 3), (n, F), (n, 5))]
        g_c_pre, g_f_pre = cots(n_c, cd), cots(n_f, cd)
        g_c_raw, g_f_raw = cots(n_c, torch.float32), cots(n_f, torch.float32)
        tr.update(g_f_pre=g_f_pre, g_f_raw=g_f_raw, g_c_raw=g_c_raw)
        S, Fm, T = kf.SIGMA, kf.FULL, kf.TRANSIENT
        # the forward's heads, the transient ones each on its own
        fwd_names = ["sigma", "rgb", "feat", "transient_sigma",
                     "transient_rgb", "transient_beta"]
        bwd_names = ["d_x", "d_dirs", "dW", "db"]

        def with_dw(p, out):
            """(d_x, d_dirs, dW matrices, db biases): the gradient blob
            split into the matrices' and the biases' parts."""
            d_x, d_dirs, dw = out
            nw = p.w.numel()
            return d_x, d_dirs, dw[:nw], dw[nw:]

        def split(out):
            s_, r_, f_, t_ = out
            return s_, r_, f_, t_[:, 0], t_[:, 1:4], t_[:, 4]

        rt = n_f - RAGGED   # not a multiple of the 128-sample block tile
        cases = []
        for name, kern, plain, xs in (
                ("K1 field_fwd_pre transient", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain, (tr["emb"], tr["embd"])),
                ("K5 field_fwd transient", kf.field_fwd, kf.field_fwd_plain,
                 (tr["pts"], tr["dirs"]))):
            for mode, n in (("transient", n_f), (f"transient N={rt}", rt)):
                cases.append((
                    name, mode, kern, plain, fwd_names,
                    lambda f, x=xs[0][:n], d=xs[1][:n]: split(f(pf, T, x,
                                                                d))))
        for name, kern, plain, xs, gs in (
                ("K2 field_bwd_pre +dW", kf.field_bwd_pre,
                 kf.field_bwd_pre_plain, ("emb_c", "embd_c", "emb", "embd"),
                 (g_c_pre, g_f_pre)),
                ("K6 field_bwd +dW", kf.field_bwd, kf.field_bwd_plain,
                 ("pts_c", "dirs_c", "pts", "dirs"), (g_c_raw, g_f_raw))):
            for mode, p, x, d, g in (
                    (S, pc, tr[xs[0]], None, gs[0][:1] + [None] * 3),
                    (Fm, pc, tr[xs[0]], tr[xs[1]], gs[0][:3] + [None]),
                    (T, pf, tr[xs[2]], tr[xs[3]], gs[1])):
                cases.append((
                    name, ("sigma", "full", "transient")[mode], kern, plain,
                    bwd_names,
                    lambda f, p=p, mode=mode, x=x, d=d, g=g: with_dw(
                        p, f(p, mode, x, d, *g, need_dw=True))))
            # the frozen backward in transient mode, its own kernel
            cases.append((
                name.replace(" +dW", ""), "transient", kern, plain,
                bwd_names[:2],
                lambda f, x=tr[xs[2]], d=tr[xs[3]], g=gs[1]: f(pf, T, x, d,
                                                              *g)[:2]))
        with torch.no_grad():
            for name, mode, kern, plain, names, case in cases:
                got = case(kern)
                torch.cuda.synchronize()
                want = case(plain)
                compare(name, mode, dt, got, want, names)
                del got, want
            # the forward: two calls, and the persistent grid against one
            # block per block tile, give the same bits
            this = build.library("fused_field")
            for name, kern, x, d in (
                    ("K1 field_fwd_pre transient", kf.field_fwd_pre,
                     tr["emb"], tr["embd"]),
                    ("K5 field_fwd transient", kf.field_fwd, tr["pts"],
                     tr["dirs"])):
                a, b = kern(pf, T, x, d), kern(pf, T, x, d)
                if not all(torch.equal(u, v) for u, v in zip(a, b)):
                    raise AssertionError(f"{name} {dt}: two calls differ")
                tile = field_call(this, name, tr, dev, 0)
                if not all(torch.equal(u, v) for u, v in zip(a, tile)):
                    raise AssertionError(f"{name} {dt}: one block per block "
                                         f"tile differs from the grid")
                grid = kf.fwd_blocks(this, pf, T, kern is kf.field_fwd, n_f,
                                     dev)
                log(f"{name} {dt}: two calls, and the grid of {grid} blocks "
                    f"against one block per block tile, bit for bit the "
                    f"same")
                del a, b, tile
            # the warp path of K2/K6, sigma and full mode at the coarse
            # training shape and transient mode at the fine one: two
            # calls (fixed summation orders), and the persistent grid
            # against one block per block tile, bit for bit; with dW also
            # over chunks of 64 x 1,001 rows, which end mid block tile,
            # against the plain version
            for name, raw, xs, gs in (("K2 field_bwd_pre", False,
                                       ("emb_c", "embd_c", "emb", "embd"),
                                       (g_c_pre, g_f_pre)),
                                      ("K6 field_bwd", True,
                                       ("pts_c", "dirs_c", "pts", "dirs"),
                                       (g_c_raw, g_f_raw))):
                kern = kf.field_bwd if raw else kf.field_bwd_pre
                for mode in (S, Fm, T):
                    p = pf if mode == T else pc
                    x = tr[xs[2 if mode == T else 0]]
                    d = (None if mode == S
                         else tr[xs[3 if mode == T else 1]])
                    g = (gs[1] if mode == T else gs[0][:1] + [None] * 3
                         if mode == S else gs[0][:3] + [None])
                    for need_dw in (False, True):
                        a = kern(p, mode, x, d, *g, need_dw=need_dw)
                        b = kern(p, mode, x, d, *g, need_dw=need_dw)
                        tile = field_bwd_call(this, raw, mode, p, x, d, g,
                                              need_dw, dev, blocks=0)
                        what = f"{name}{' +dW' if need_dw else ''}"
                        for u, v, w_ in zip(a, b, tile):
                            if u is None:
                                continue
                            if not torch.equal(u, v):
                                raise AssertionError(f"{what} {MODES[mode]} "
                                                     f"{dt}: two calls "
                                                     f"differ")
                            if not torch.equal(u, w_):
                                raise AssertionError(
                                    f"{what} {MODES[mode]} {dt}: one block "
                                    f"per block tile differs from the grid")
                        log(f"{what} {MODES[mode]} {dt}: two calls, and the "
                            f"grid against one block per block tile, bit "
                            f"for bit the same")
                        del a, b, tile
                    chunk = kf.TILE_ROWS * 1001
                    got = field_bwd_call(this, raw, mode, p, x, d, g, True,
                                         dev, chunk=chunk)
                    plain = kf.field_bwd_plain if raw else \
                        kf.field_bwd_pre_plain
                    want = plain(p, mode, x, d, *(g if mode == T else g[:3]),
                                 need_dw=True)
                    compare(f"{name} +dW", f"{MODES[mode]} in chunks of "
                            f"{chunk} rows", dt, with_dw(p, got),
                            with_dw(p, want), bwd_names)
                    del got, want
            # the dW kernel alone on the first chunk of each training pass
            for label, p, mode, x, d, g in (
                    ("fine transient", pf, T, tr["pts"], tr["dirs"], g_f_raw),
                    ("coarse full", pc, Fm, tr["pts_c"], tr["dirs_c"],
                     g_c_raw[:3] + [None])):
                ops, tile_b, rows, slices = first_chunk(p, mode, x, d, g)
                nw = p.w.numel()
                part = kf.field_dw(p, mode, ops, tile_b, rows, torch.zeros(
                    (slices, nw + p.b.numel()), device=dev))
                got = kf._dw_reduce(build.library("fused_field"), part)
                want = kf.field_dw_plain(p, mode, ops, tile_b, rows)
                compare("K2/K6 field_dw", f"{label}, {rows} rows, {slices} "
                        f"slices", dt, (got[:nw], got[nw:]),
                        (want[:nw], want[nw:]), ["dW", "db"])
                del ops, tile_b, part, got, want
        torch.cuda.empty_cache()

    def first_chunk(p, mode, x, d, g):
        """The dW operands of the first chunk of K6 +dW on raw inputs x, d
        with f32 cotangents g, as the wrapper's plan makes it: (ops,
        tile_b, rows, slices)."""
        lib = build.library("fused_field")
        n, sp = x.shape[0], p.spec
        chunk, slices = kf.dw_plan(
            lib, p, mode, n,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        rows = min(chunk, n)
        ops = torch.empty(chunk * lib.nefes_field_dw_row_elems(
            mode, *kf.dims(sp)), dtype=sp.torch_dtype, device=dev)
        tile_b = torch.zeros((chunk // kf.TILE_ROWS, p.b.numel()),
                             device=dev)
        dx, dd = (torch.empty((n, 3), device=dev) for _ in range(2))
        err = lib.nefes_field_bwd_raw(
            kf._DTYPE_CODE[sp.torch_dtype], mode, n, x.data_ptr(), kf._ptr(d),
            p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(), *kf.dims(sp),
            *[kf._ptr(v) for v in g], dx.data_ptr(), dd.data_ptr(), 0, rows,
            p.b.numel(), ops.data_ptr(), tile_b.data_ptr(), kf._stream())
        kf.raise_on(err, "K6 field_bwd")
        return ops, tile_b, rows, slices

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
    # each kernel's wrapper by its name in KERNELS (the variants below are
    # counted on the wrappers of K1, K2, K5 and K6)
    wrappers = {
        "K1 field_fwd_pre": kf.field_fwd_pre,
        "K2 field_bwd_pre": kf.field_bwd_pre,
        "K3 render_fwd_pre": kr.render_fwd_pre,
        "K4 render_bwd_pre": kr.render_bwd_pre,
        "K5 field_fwd": kf.field_fwd, "K6 field_bwd": kf.field_bwd,
        "K7 render_fwd": kr.render_fwd, "K8 render_bwd": kr.render_bwd,
        "K9 chain": km.chain, "K10 chain_interleaved": km.chain_interleaved,
        "K11 embed_micro": km.embed_micro, "K12 chain_sq": km.chain_sq,
        "K2/K6 field_dw": kf.field_dw,
    }
    all_kernels = tuple(wrappers.values())
    # the training variants' own counters (also counted in `launches`)
    variants = {
        "K1 field_fwd_pre transient": (kf.field_fwd_pre,
                                       "transient_launches"),
        "K2 field_bwd_pre +dW": (kf.field_bwd_pre, "dw_launches"),
        "K5 field_fwd transient": (kf.field_fwd, "transient_launches"),
        "K6 field_bwd +dW": (kf.field_bwd, "dw_launches"),
    }
    # the kernels (and variants) each training path must launch
    path_kernels.update({
        "train_raw": ("K5 field_fwd", "K6 field_bwd",
                      "K5 field_fwd transient", "K6 field_bwd +dW",
                      "K2/K6 field_dw"),
        "train_pre": ("K1 field_fwd_pre", "K2 field_bwd_pre",
                      "K1 field_fwd_pre transient", "K2 field_bwd_pre +dW",
                      "K2/K6 field_dw"),
        "train_unfused": (),
        # the probe's commands: kernelmicro; kernel and perf
        "micro": ("K9 chain", "K10 chain_interleaved", "K11 embed_micro",
                  "K12 chain_sq", "K5 field_fwd", "K1 field_fwd_pre",
                  "K2 field_bwd_pre"),
        "probe": ("K5 field_fwd", "K6 field_bwd", "K7 render_fwd",
                  "K8 render_bwd", "K1 field_fwd_pre", "K3 render_fwd_pre",
                  "K4 render_bwd_pre"),
    })

    def snapshot_counts():
        return ([k.launches for k in all_kernels],
                {n: getattr(k, a) for n, (k, a) in variants.items()})

    def restore_counts(saved):
        for k, c in zip(all_kernels, saved[0]):
            k.launches = c
        for n, (k, a) in variants.items():
            setattr(k, a, saved[1][n])

    def reset_counts():
        for k in all_kernels:
            k.launches = 0
        for k, attr in variants.values():
            setattr(k, attr, 0)

    def counted(cfg_name, fn):
        """Run fn with every launch count set to 0 just before it; returns
        (its result, seconds, the counts), and fails if the path did not
        launch exactly its own kernels and variants."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: k.launches for n, k in wrappers.items()}
        counts.update({n: getattr(k, attr)
                       for n, (k, attr) in variants.items()})
        ran = {n for n, c in counts.items() if c}
        if ran != set(path_kernels[cfg_name]):
            raise AssertionError(f"{cfg_name} launched {sorted(ran)}, "
                                 f"expected {path_kernels[cfg_name]}")
        return out, dt, {n: c for n, c in counts.items() if c}

    def peak_mib(held: int, what: str = "the frame") -> str:
        peak = torch.cuda.max_memory_allocated()
        return (f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB "
                f"above the {held / 2**20:.1f} MiB held before {what}")

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

    def train_batch(F):
        """rgb targets uniform (seed 5), feature targets normal (seed 6),
        the TRAIN_B poses, the rgb targets' luminance histograms."""
        from nefes_tpu_torch.data.scene import compute_histograms
        rgb = torch.rand((TRAIN_B, H, W, 3),
                         generator=torch.Generator().manual_seed(5))
        feat = torch.randn((TRAIN_B, H, W, F),
                           generator=torch.Generator().manual_seed(6))
        hists = torch.from_numpy(compute_histograms(rgb.numpy()))
        return {"rgb": rgb.to(dev), "feat": feat.to(dev),
                "poses": train_poses(dev), "hists": hists.to(dev)}

    def train_model(dt):
        return NeFeSModel(ModelConfig(dtype=kf._DTYPES[dt]), device=dev,
                          generator=torch.Generator().manual_seed(0))

    def train_cfg(model, path):
        cfg = model.cfg.render_config(n_samples=N_C, n_importance=N_F,
                                      perturb=True, output_transient=True,
                                      remat=False)
        flags = {"train_raw": dict(fused=True, fused_pre=False),
                 "train_pre": dict(fused=True, fused_pre=True),
                 "train_unfused": {}}[path]
        return replace_cfg(cfg, fused_need_dw=True, **flags)

    def train_run(path, st, batch, steps, gen, stage=1, lr=TRAIN_LR,
                  scene=None):
        """`steps` steps of `path` on the train state st; (losses, seconds,
        launch counts). stage 2 runs the patch step."""
        from nefes_tpu_torch.train import train_step_patch, train_step_rays
        cfg = train_cfg(st.model, path)
        hwf, near, far = scene or ((H, W, FOCAL), NEAR, FAR)

        def steps_():
            losses = []
            for i in range(steps):
                lr_i = lr(i) if callable(lr) else lr
                if stage == 2:
                    _, loss, _ = train_step_patch(st, cfg, batch, gen, lr_i,
                                                  hwf, near, far)
                else:
                    _, loss, _ = train_step_rays(st, cfg, batch, gen, lr_i,
                                                 hwf, near, far,
                                                 n_rand=N_RAND, stage=stage)
                losses.append(loss)
            return torch.stack(losses).float().cpu()
        return counted(path, steps_)

    def flat_params(model):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in model.parameters()])

    def do_train():
        from nefes_tpu_torch.train import create_train_state, lr_for_epoch
        F = ModelConfig().feature_dim
        batch = train_batch(F)
        rays = TRAIN_B * N_RAND
        # the main path: K5 and K6 with dW, bf16
        st = create_train_state(train_model("bfloat16"))
        gen = torch.Generator(device=dev).manual_seed(7)
        train_run("train_raw", st, batch, 2, gen)          # warm-up
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses, secs, counts = train_run("train_raw", st, batch, TRAIN_STEPS,
                                         gen)
        peak = peak_mib(held, "the steps")
        step_s = secs / TRAIN_STEPS
        log(f"train train_raw: {step_s:.4f} s/step, {rays / step_s:.1f} "
            f"rays/s ({TRAIN_STEPS} steps of {TRAIN_B}x{N_RAND} rays, "
            f"{N_C}+{N_F} samples, stage 1, transient heads, NeFeS bf16)")
        log(f"  losses {[round(float(x), 6) for x in losses]}")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        if not torch.isfinite(losses).all():
            raise AssertionError("non-finite training loss")
        # the backward with dW launches once a chunk of rows, each chunk
        # followed by the dW kernel: the coarse pass (full mode) and the
        # fine pass (transient mode) by dw_plan's chunks
        with torch.no_grad():
            pc, pf = st.model.pack_fused()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lib = build.library("fused_field")
        chunks = 0
        for p, mode, n in ((pc, kf.FULL, rays * N_C),
                           (pf, kf.TRANSIENT, rays * (N_C + N_F))):
            chunk, slices = kf.dw_plan(lib, p, mode, n, sms)
            chunks += -(-n // chunk)
            log(f"  dW plan {('sigma', 'full', 'transient')[mode]} mode, {n} "
                f"rows: chunks of {chunk} rows, {slices} row slices")
        want = {"K5 field_fwd": 2, "K6 field_bwd": chunks,
                "K5 field_fwd transient": 1, "K6 field_bwd +dW": chunks,
                "K2/K6 field_dw": chunks}
        for name, per_step in want.items():
            if counts.get(name) != per_step * TRAIN_STEPS:
                raise AssertionError(f"{name}: {counts.get(name)} launches "
                                     f"in {TRAIN_STEPS} steps, expected "
                                     f"{per_step} per step")
        for name in ("K5 field_fwd transient", "K6 field_bwd +dW",
                     "K2/K6 field_dw"):
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "train train_raw"

        # 3 stage-2 patch steps through the kernels, continuing
        bn = st.model.fusion.bn
        before = (bn.running_mean.clone(), bn.running_var.clone())
        losses, secs, counts = train_run("train_raw", st, batch, 3, gen,
                                         stage=2)
        moved = max((bn.running_mean - before[0]).abs().max().item(),
                    (bn.running_var - before[1]).abs().max().item())
        log(f"train stage 2 (patch) train_raw: losses "
            f"{[round(float(x), 6) for x in losses]}, {secs / 3:.4f} s/step,"
            f" BN running stats moved by {moved:.3e} (max abs), launches "
            f"{counts}")
        if not (torch.isfinite(losses).all() and moved > 0):
            raise AssertionError("stage-2 step: non-finite loss or BN "
                                 "running stats unchanged")

        # the paths from one initial state and generator seed, bf16 and f32
        for dt in ("bfloat16", "float32"):
            runs = {}
            for path in ("train_raw", "train_pre", "train_unfused"):
                m = train_model(dt)
                p0 = flat_params(m)
                st_p = create_train_state(m)
                gen_p = torch.Generator(device=dev).manual_seed(8)
                losses, secs, counts = train_run(path, st_p, batch,
                                                 PATH_STEPS, gen_p)
                runs[path] = (losses, flat_params(m))
                log(f"train {dt} {path}: {PATH_STEPS} steps in "
                    f"{secs:.3f} s, losses "
                    f"{[round(float(x), 6) for x in losses]}, launches "
                    f"{counts}")
                if dt == "bfloat16" and path == "train_pre":
                    for name in ("K1 field_fwd_pre transient",
                                 "K2 field_bwd_pre +dW"):
                        kernels[name]["launches"] = counts[name]
                        kernels[name]["path"] = "train train_pre"
                del st_p, m
            ref_l, ref_p = runs["train_raw"]
            tol = PATHS_RTOL * float(ref_l[0])
            for path in ("train_pre", "train_unfused"):
                l, prm = runs[path]
                diff = (l - ref_l).abs().max().item()
                rel = ((prm - ref_p).norm() / ref_p.norm()).item()
                rel_step = ((prm - ref_p).norm()
                            / (ref_p - p0).norm()).item()
                log(f"train {dt}: max |loss({path}) - loss(train_raw)| = "
                    f"{diff:.3e} (tolerance {tol:.3e}); parameters after "
                    f"{PATH_STEPS} steps: rel L2 {rel:.3e} (tolerance "
                    f"{PARAM_TOL[dt]:.0e}), {rel_step:.3e} of what the "
                    f"steps moved them")
                if not diff <= tol:
                    raise AssertionError(f"train {dt} {path}: losses "
                                         f"disagree")
                if not rel <= PARAM_TOL[dt]:
                    raise AssertionError(f"train {dt} {path}: parameters "
                                         f"disagree")
            torch.cuda.empty_cache()

        # the loss falls on the synthetic blob scene (stage 0, the JAX
        # package's tests/test_training_e2e.py recipe at full width)
        from nefes_tpu_torch.data.synthetic import make_synthetic_scene
        scene = make_synthetic_scene(n_views=8, H=H, W=W, focal=FOCAL,
                                     device=dev)
        sb = {"rgb": torch.from_numpy(scene.images[:TRAIN_B]).to(dev),
              "poses": torch.from_numpy(scene.poses[:TRAIN_B]).to(dev),
              "hists": torch.from_numpy(scene.hists[:TRAIN_B]).to(dev)}
        st_s = create_train_state(train_model("bfloat16"))
        losses, secs, _ = train_run(
            "train_raw", st_s, sb, 30, torch.Generator(device=dev)
            .manual_seed(9), stage=0, lr=lambda i: lr_for_epoch(i, 5e-3),
            scene=(scene.hwf, scene.near, scene.far))
        first, last = losses[:5].mean().item(), losses[-5:].mean().item()
        log(f"train synthetic scene, stage 0, train_raw: mean loss of the "
            f"first 5 steps {first:.6f}, of the last 5 {last:.6f}")
        if not last < 0.8 * first:
            raise AssertionError("the training loss did not fall")

    phase("train", do_train)

    @torch.no_grad()
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
        fl = probe.tower_flops(sp, samples=z.shape[1])
        el = probe.embed_ops(sp.n_freqs_xyz, sp.n_freqs_dir)
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
        # the training variants at the fine training shape (transient
        # mode), their gradients f32
        tr = state["train_inputs"]["bfloat16"]
        _, tpf = tr["packed"]
        temb, tembd, tpts, tdirs = tr["emb"], tr["embd"], tr["pts"], tr["dirs"]
        g_pre, g_rw = tr["g_f_pre"], tr["g_f_raw"]
        n_t, T = temb.shape[0], kf.TRANSIENT
        heads_t = 1 + 3 + sp.feature_dim + 5
        dw_bytes = (tpf.w.numel() + tpf.b.numel()) * b4
        rows.update({
            "K1 field_fwd_pre transient": (
                lambda f: f(tpf, T, temb, tembd), kf.field_fwd_pre,
                kf.field_fwd_pre_plain,
                lambda: chain(tpf, T, temb, tembd, False),
                n_t * fl["fwd_t"], 0,
                n_t * (sp.emb_xyz + sp.emb_dir + heads_t) * b2),
            "K2 field_bwd_pre +dW": (
                lambda f: f(tpf, T, temb, tembd, *g_pre, need_dw=True),
                kf.field_bwd_pre, kf.field_bwd_pre_plain,
                lambda: chain(tpf, T, temb, tembd, True, dw=True),
                n_t * fl["bwd_dw_t"], 0,
                n_t * (2 * (sp.emb_xyz + sp.emb_dir) + heads_t) * b2
                + dw_bytes),
            "K5 field_fwd transient": (
                lambda f: f(tpf, T, tpts, tdirs), kf.field_fwd,
                kf.field_fwd_plain,
                lambda: chain(tpf, T, temb, tembd, False),
                n_t * fl["fwd_t"], n_t * el["fwd"],
                n_t * (2 * 3 + heads_t) * b4),
            "K6 field_bwd +dW": (
                lambda f: f(tpf, T, tpts, tdirs, *g_rw, need_dw=True),
                kf.field_bwd, kf.field_bwd_plain,
                lambda: chain(tpf, T, temb, tembd, True, dw=True),
                n_t * fl["bwd_dw_t"], n_t * (el["fwd"] + el["bwd"]),
                n_t * (4 * 3 + heads_t) * b4 + dw_bytes),
        })
        # the dW kernel alone on the fine pass's first chunk: 2 K N FLOPs a
        # row a product (a bias: K = 1); its operands and the head biases'
        # tile sums read once, the slices' partials read and written
        dops, dtb, drows, dslices = first_chunk(tpf, T, tpts, tdirs, g_rw)
        dpart = torch.zeros((dslices, tpf.w.numel() + tpf.b.numel()),
                            device=dev)
        views = kf.dw_operands(tpf.spec, T, dops, drows)
        prods = kf.dw_products(tpf.spec, T)
        from_g, heads = kf.dw_biases(tpf.spec, T)
        kn = sum(tpf.weights[nm].numel()
                 for nm in [p_[2] for p_ in prods] + [b_[1] for b_ in from_g])
        head_b = sum(tpf.weights[nm].numel() for nm in heads)
        row_elems = build.library("fused_field").nefes_field_dw_row_elems(
            T, *kf.dims(tpf.spec))
        rows["K2/K6 field_dw"] = (
            lambda f: (f(tpf, T, dops, dtb, drows) if f is kf.field_dw_plain
                       else f(tpf, T, dops, dtb, drows, dpart)),
            kf.field_dw, kf.field_dw_plain,
            lambda: ([views[a].t() @ views[g] for a, g, _ in prods]
                     + [views[g].sum(0, dtype=torch.float32)
                        for g, _ in from_g]),
            2 * drows * kn, 0,
            drows * row_elems * b2 + -(-drows // kf.TILE_ROWS) * head_b * b4
            + 2 * dpart.numel() * b4)
        # the weights each function reads: the static tower, and with the
        # transient heads for the training variants
        static = replace_cfg(sp, transient=False)
        static_bytes = (
            sum(pf.weights[n].numel() for n in kf.matrix_names(static)) * b2
            + sum(pf.weights[n].numel() for n in kf.bias_names(static)) * b4)
        train_bytes = tpf.w.numel() * b2 + tpf.b.numel() * b4
        for name, (case, kern, plain, lib_fn, flops, ew, nbytes) in \
                rows.items():
            saved = snapshot_counts()
            ms = time_ms(lambda: case(kern))
            restore_counts(saved)      # timing launches are not the path's
            plain_ms = time_ms(lambda: case(plain), reps=3)
            lib_ms = time_ms(lib_fn, reps=3)
            if name != "K2/K6 field_dw":     # it reads no weights
                nbytes += train_bytes if name in variants else static_bytes
            bound_ms, bound_by = probe.bound(flops, ew, nbytes)
            kernels[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                flops=flops + ew, bytes=nbytes)
            earlier = (f" (first version {EARLIER_MS[name]:.3f} ms, "
                       f"PERF.md)" if name in EARLIER_MS else "")
            log(f"{name}: {ms:.3f} ms{earlier} (bound {bound_ms:.4f} ms "
                f"by {kernels[name]['bound_by']}: {flops / 1e9:.1f} GFLOP "
                f"bf16 + {ew / 1e9:.3f} G f32 ops, {nbytes / 1e6:.1f} MB; "
                f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
                f"bf16 matmul chain {lib_ms:.3f} ms")
        time_turns(rows)

    def time_turns(rows):
        """Kernels in turns on the time phase's inputs, each variant
        called the same way (field_call, render_call, bwd_call), so the
        host's share is the same: K1 and K5, in sigma mode (the main
        path's coarse pass) and in transient mode (training's fine pass),
        on their persistent grid and on one block per block tile (whose
        outputs must be equal); with --parent also
        the parent tree's K1 and K5 and, of both trees, K3, K4, K7 and K8,
        K2 and K6 in transient mode with dW and frozen (the fine training
        pass), and K2 and K6 in full mode (frozen on the refinement's fine
        pass; K6 +dW on the coarse training pass), the backwards of this
        tree also on one block per block tile, each of the parent's
        checked against its plain version first
        (relative L2). 5 rounds of the variants in
        order and then in reverse (this, tile, tile, this or parent, this,
        this, parent, ...), the median of each one's 10 times."""
        names = list(_FIELD_ENTRY)
        if parent:
            names += list(_RENDER_ENTRY) + list(_BWD_ENTRY)
        for name in names:
            field = name in _FIELD_ENTRY
            src, call = (("fused_field", field_call) if field
                         else ("fused_field", bwd_call)
                         if name in _BWD_ENTRY
                         else ("fused_render", render_call))
            # this tree also on one block per block tile: the field
            # forward and backward
            tile = field or name in _BWD_ENTRY
            train = (name.endswith("transient")
                     or name in _BWD_ENTRY and _BWD_ENTRY[name][2])
            ins = state["train_inputs" if train else "inputs"]["bfloat16"]
            this = build.library(src)
            fns = {}
            if parent:
                lib = build.library(src, **parent)
                got = call(lib, name, ins, dev)
                want = (bwd_plain(name, ins) if name in _BWD_ENTRY
                        else rows[name][0](rows[name][2]))
                if torch.is_tensor(want):       # a forward's one output
                    want = (want,)
                l2 = max(float((a.float() - b.float()).norm()
                               / b.float().norm())
                         for a, b in zip(got, want))
                if not l2 <= TOL["bfloat16"]:
                    raise AssertionError(f"parent {name}: rel_l2 {l2:.3e}")
                log(f"parent {name}: rel_l2 {l2:.3e} against plain")
                del got, want
                fns["parent"] = lambda lib=lib: call(lib, name, ins, dev)
            fns["this"] = lambda: call(this, name, ins, dev)
            if tile:
                fns["tile"] = lambda: call(this, name, ins, dev, 0)
                if not all(torch.equal(a, b) for a, b in
                           zip(fns["tile"](), fns["this"]())):
                    raise AssertionError(f"{name}: one block per block "
                                         f"tile differs from the grid")
            keys = list(fns)
            times = {k: [] for k in keys}
            for f in (*fns.values(), *fns.values()):     # warm
                f()
            for _ in range(5):
                for k in keys + keys[::-1]:
                    times[k].append(event_ms(fns[k]))
            ms = {k: statistics.median(v) for k, v in times.items()}
            label = {"this": "this tree", "parent": "parent",
                     "tile": "this tree on one block per block tile"}
            earlier = (f" (first design {EARLIER_MS[name]:.3f} ms, PERF.md)"
                       if name in EARLIER_MS else "")
            log(f"{name} in turns{earlier}: " + ", ".join(
                f"{label[k]} {ms[k]:.3f} ms ({ms[k] / ms['this']:.3f}x)"
                for k in keys) + "; times " + "; ".join(
                f"{k} {[round(t, 3) for t in times[k]]}" for k in keys))
            torch.cuda.empty_cache()

    @torch.no_grad()
    def time_coarse_training():
        """The coarse pass of a training step (full mode, half the fine
        samples): K5 forward (and K1 on the embeddings) and K6 with dW,
        their ms."""
        tr = state["train_inputs"]["bfloat16"]
        pc = tr["packed"][0]
        n_c = tr["pts_c"].shape[0]
        gen = torch.Generator(device=dev).manual_seed(3)
        g = [torch.randn(s_, device=dev, generator=gen)
             for s_ in ((n_c,), (n_c, 3), (n_c, pc.spec.feature_dim))]
        saved = snapshot_counts()
        fwd = time_ms(lambda: kf.field_fwd(pc, kf.FULL, tr["pts_c"],
                                           tr["dirs_c"]))
        fwd_pre = time_ms(lambda: kf.field_fwd_pre(pc, kf.FULL, tr["emb_c"],
                                                   tr["embd_c"]))
        bwd = time_ms(lambda: kf.field_bwd(pc, kf.FULL, tr["pts_c"],
                                           tr["dirs_c"], *g, need_dw=True))
        # the fine pass's K6 +dW by part: the frozen backward over every
        # row, one chunk's backward writing its dW operands, the dW kernel
        # on one chunk
        _, pf = tr["packed"]
        T, x, d, g_f = kf.TRANSIENT, tr["pts"], tr["dirs"], tr["g_f_raw"]
        n_f = x.shape[0]
        frozen = time_ms(lambda: kf.field_bwd(pf, T, x, d, *g_f))
        frozen_pre = time_ms(lambda: kf.field_bwd_pre(pf, T, tr["emb"],
                                                      tr["embd"], *tr["g_f_pre"]))
        ops, tile_b, rows, slices = first_chunk(pf, T, x, d, g_f)
        chunk_ms = time_ms(lambda: first_chunk(pf, T, x, d, g_f))
        part = torch.zeros((slices, pf.w.numel() + pf.b.numel()), device=dev)
        dw_ms = time_ms(lambda: kf.field_dw(pf, T, ops, tile_b, rows, part))
        restore_counts(saved)
        chunks = -(-n_f // rows)
        log(f"coarse training pass ({n_c} samples, full mode): K5 field_fwd "
            f"{fwd:.3f} ms (K1 field_fwd_pre {fwd_pre:.3f} ms), K6 "
            f"field_bwd +dW {bwd:.3f} ms")
        log(f"fine training pass ({n_f} samples, transient mode): K6 "
            f"field_bwd without dW {frozen:.3f} ms (K2 {frozen_pre:.3f} ms; "
            f"first design {EARLIER_MS['K6 field_bwd transient']} / "
            f"{EARLIER_MS['K2 field_bwd_pre transient']} ms, PERF.md); "
            f"with dW in {chunks} chunks of {rows} rows: the backward "
            f"{chunk_ms:.3f} ms a chunk, the dW kernel {dw_ms:.3f} ms a chunk "
            f"({slices} slices); {chunks} x both = "
            f"{chunks * (chunk_ms + dw_ms):.3f} ms")

    def do_time_all():
        do_time()
        time_coarse_training()

    phase("time", do_time_all)

    # the row of each micro-benchmark kernel in the kernels line: K9 at
    # tile 2048 (K10's tile), K10 with 4 sub-tiles, K11 at tile 2048, K12
    # at width 128 (N rows); kernelmicro prints every tile and width
    micro_rows = {"K9 chain": "chain8_tile2048_ms",
                  "K10 chain_interleaved": "chain8_interleave4_ms",
                  "K11 embed_micro": "embed_tile2048_ms",
                  "K12 chain_sq": "sq_chain8_w128_ms"}

    def do_micro():
        from types import SimpleNamespace
        # the JAX probe's tiles, and 64 rows (micro.cu's sub-tile, TR)
        tiles = [64, 512, 2048, 8192]
        out, secs, counts = counted("micro", lambda: probe.cmd_kernelmicro(
            SimpleNamespace(device="cuda", tiles=tiles, out="")))
        log(f"micro: kernelmicro in {secs:.1f} s, launches {counts}")
        for name, key in micro_rows.items():
            row = out["kernels"][key]
            kernels[name].update(
                {k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
                launches=counts[name], path=f"probe kernelmicro ({key})")
        # each kernel against its plain version, at every tile and width
        # of the run (these launches are not the path's)
        ins = probe.micro_inputs(dev, probe.H * probe.W * 128)
        cw, x, pts = ins["chain"], ins["x"], ins["pts"]
        bf = "bfloat16"
        with torch.no_grad():
            want = km.chain_plain(cw, x)
            for tile in tiles:
                compare("K9 chain", f"tile {tile}", bf,
                        (km.chain(cw, x, tile),), (want,))
            k9 = km.chain(cw, x, 2048)
            for nb in (2, 4):
                got = km.chain_interleaved(cw, x, 2048, nb)
                compare("K10 chain_interleaved", f"x{nb} tile 2048", bf,
                        (got,), (want,))
                if not torch.equal(got, k9):
                    raise AssertionError(f"K10 x{nb} differs from K9 at "
                                         f"tile 2048")
            del want, k9, got
            want = km.embed_micro_plain(pts)
            for tile in tiles:
                got = km.embed_micro(pts, tile)
                compare("K11 embed_micro", f"tile {tile}", bf, (got,),
                        (want,))
                if not torch.equal(got, want):
                    raise AssertionError(f"K11 tile {tile}: not bit for bit")
            log("K10 equals K9 at tile 2048; K11 equals its plain version "
                "bit for bit at every tile")
            for w_, tile in ((128, 2048), (256, 512)):
                scw, sx = ins["sq"][w_]
                compare("K12 chain_sq", f"w{w_} tile {tile}", bf,
                        (km.chain_sq(scw, sx, tile),),
                        (km.chain_plain(scw, sx),))
        torch.cuda.empty_cache()

    phase("micro", do_micro)

    def do_probe():
        from types import SimpleNamespace
        (res_k, res_p), secs, counts = counted("probe", lambda: (
            probe.cmd_kernel(SimpleNamespace(device="cuda", sweep=True)),
            probe.cmd_perf(SimpleNamespace(device="cuda", refine_n=1))))
        log(f"probe: kernel and perf in {secs:.1f} s, launches {counts}")
        bad = [k for k, v in {**res_k, **res_p}.items()
               if not (np.isfinite(v) and v >= 0)]
        if bad:
            raise AssertionError(f"probe: non-finite or negative {bad}")
        # K5 bf16 must sit within the plain bf16 field's band around the
        # plain f32 field (the JAX probe's criterion), here 4x its max-abs
        for key in ("static_sigma", "static_rgb", "static_feat"):
            e_k = res_k[f"{key}_maxerr_kern16"]
            e_p = res_k[f"{key}_maxerr_plain16"]
            if not e_k <= PROBE_BAND * e_p:
                raise AssertionError(f"probe kernel: K5 {key} max-abs "
                                     f"{e_k:.3e} from f32, plain bf16 "
                                     f"{e_p:.3e}")
        if not res_k["fused_render_rgb_maxerr"] <= PROBE_RGB_TOL:
            raise AssertionError("probe kernel: fused render rgb differs "
                                 "from the unfused fine pass")
        torch.cuda.empty_cache()

    phase("probe", do_probe)

    def profiled(what, fn):
        """Run fn under torch.profiler; log the wall time, the device's
        busy share (the union of the kernels' spans) and the device time
        of the top kernels."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6          # us
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kern:
            log(f"profile {what}: the trace holds no device time")
            return
        busy, end = 0.0, -1.0
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in kern):
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name: dict = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
        log(f"profile {what}: {wall / 1e3:.1f} ms wall, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / wall:.1f} %), idle "
            f"{100 - 100 * busy / wall:.1f} %")
        for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            log(f"  {us / 1e3:9.3f} ms  {name[:90]}")

    def do_profile():
        """The device's busy share and time per kernel on each main path:
        3 train_raw steps, 5 iterations of mode 3 (render_pre) and of mode
        2 (render_raw)."""
        from nefes_tpu_torch.train import create_train_state
        batch = train_batch(ModelConfig().feature_dim)
        st = create_train_state(train_model("bfloat16"))
        gen = torch.Generator(device=dev).manual_seed(7)
        train_run("train_raw", st, batch, 2, gen)          # warm-up
        profiled("train train_raw, 3 steps",
                 lambda: train_run("train_raw", st, batch, 3, gen))
        profiled("mode3 render_pre, 5 iterations",
                 lambda: refine3("render_pre", 5))
        profiled("mode2 render_raw, 5 iterations",
                 lambda: refine2("render_raw", 5))

    phase("profile", do_profile)
    return finish(failed, kernels, smi)


def finish(failed, kernels, smi) -> int:
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"card: {smi}")       # again, beside the results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [{k: v.get(k) for k in keys} | {"path": v.get("path")}
            for v in kernels.values()]
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_label(line: str) -> str:
    """A short name for ptxas's 'Compiling entry function' line: the
    mangled name's kernel, and for the warp-path kernels their dtype, input
    kind and the field forward's mode or, for a render backward, where it
    keeps its per-sample state."""
    import re
    name = line.split("'")[1] if "'" in line else line.strip()
    dt = "bf16" if "nv_bfloat16" in name else "f32"
    if "field_warp_kernel" in name:
        flags = re.findall(r"Lb([01])", name)   # RAW (an earlier tree: HEADS)
        mode = re.findall(r"Li([0-2])E", name)  # MODE
        mode = (MODES[int(mode[0])] if mode else
                "full" if flags[1:2] == ["1"] else "sigma")
        return (f"field_warp_kernel<{dt},"
                f"{'raw' if flags[:1] == ['1'] else 'pre'},{mode}>")
    if "field_bwd_warp_kernel" in name:
        flags = re.findall(r"Lb([01])", name)   # RAW, DW
        mode = re.findall(r"Li([0-2])E", name)  # MODE
        return (f"field_bwd_warp_kernel<{dt},"
                f"{'raw' if flags[:1] == ['1'] else 'pre'},"
                f"{MODES[int(mode[0])] if mode else '?'},"
                f"{'dW' if flags[1:2] == ['1'] else 'frozen'}>")
    for kern in ("render_bwd_kernel", "render_fwd_kernel"):
        if kern in name:
            flags = re.findall(r"Lb([01])", name)   # RAW, then GLOBAL
            where = (",global" if flags[1:] == ["1"] else ",smem"
                     if flags[1:] else "")
            return (f"{kern}<{dt},"
                    f"{'raw' if flags[:1] == ['1'] else 'pre'}{where}>")
    return name


# each render kernel's entry point: (name, raw, backward)
_RENDER_ENTRY = {"K3 render_fwd_pre": ("nefes_render_fwd_pre", False, False),
            "K4 render_bwd_pre": ("nefes_render_bwd_pre", False, True),
            "K7 render_fwd": ("nefes_render_fwd_raw", True, False),
            "K8 render_bwd": ("nefes_render_bwd_raw", True, True)}


def render_call(lib, name, ins, dev):
    """One launch of render kernel `name` from the fused_render library
    `lib` (this tree's or another's) on the main path's bf16 inputs `ins`
    (the backward with their g_ray), with the arguments the wrappers pass
    but none of their checks or launch counts; its outputs. A backward
    from before the global scratch (no nefes_render_bwd_scratch_bytes)
    takes no scratch argument."""
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr
    fn, raw, backward = _RENDER_ENTRY[name]
    pf = ins["packed"][1]
    sp, z, f32 = pf.spec, ins["z"], torch.float32
    R, S = z.shape
    x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"], ins["embd"])
    if backward:
        width, dt = ((3, 3), f32) if raw else ((sp.emb_xyz, sp.emb_dir),
                                               sp.torch_dtype)
        outs = [torch.empty((R * S, n), dtype=dt, device=dev) for n in width]
        outs.append(torch.empty((R, S), dtype=f32, device=dev))
        args = (pf.w, pf.wt, pf.b, *kf.dims(sp), ins["g_ray"])
    else:
        outs = [torch.empty((R, sp.rgbfeat + 2), dtype=f32, device=dev)]
        args = (pf.w, pf.b, *kf.dims(sp))
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    ptrs = [o.data_ptr() for o in outs]
    if backward and hasattr(lib, "nefes_render_bwd_scratch_bytes"):
        scratch = kr.bwd_scratch(lib, pf, R, S, dev)
        ptrs.append(kf._ptr(scratch))
    err = getattr(lib, fn)(kf._DTYPE_CODE[sp.torch_dtype], R, S,
                           x.data_ptr(), xd.data_ptr(), z.data_ptr(), *args,
                           *ptrs, kf._stream())
    kf.raise_on(err, fn)
    return outs


def field_bwd_call(lib, raw, mode, p, x, xd, g, need_dw, dev, blocks=None,
                   chunk=None):
    """One K2 or (raw) K6 in `mode` from the fused_field library `lib`
    (this tree's or an earlier one's, from the dW kernel on) with the
    wrapper's arguments but none of its checks or launch counts: (d_x,
    d_dirs or None, with need_dw the f32 weight gradients, else None). g:
    the four head cotangents (None where the mode has none). blocks: this
    tree's grid of the warp path through the _grid entry point (0: one
    block per block tile; None: the entry point's own). chunk: the rows of
    a chunk with dW (None: dw_plan's)."""
    from nefes_tpu_torch.kernels import fused_field as kf
    sp, n, nb = p.spec, x.shape[0], p.b.numel()
    widths, hd = (((3, 3), torch.float32) if raw
                  else ((sp.emb_xyz, sp.emb_dir), sp.torch_dtype))
    dx = torch.empty((n, widths[0]), dtype=hd, device=dev)
    dd = (torch.empty((n, widths[1]), dtype=hd, device=dev)
          if mode != kf.SIGMA else None)
    grid = () if blocks is None else (blocks,)
    fn = getattr(lib, f"nefes_field_bwd_{'raw' if raw else 'pre'}"
                 + ("_grid" if grid else ""))
    head = (kf._DTYPE_CODE[sp.torch_dtype], mode, n, x.data_ptr(),
            kf._ptr(xd), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
            *kf.dims(sp), *[kf._ptr(v) for v in g], dx.data_ptr(),
            kf._ptr(dd))

    def bwd(row0, rows, ops, tile_b):
        kf.raise_on(fn(*head, row0, rows, nb, kf._ptr(ops), kf._ptr(tile_b),
                       *grid, kf._stream()), "field_bwd")

    if not need_dw:
        bwd(0, n, None, None)
        return dx, dd, None

    def dw(ops, tile_b, rows, part):
        kf.raise_on(kf.dw_launch(lib, p, mode, ops, tile_b, rows, part,
                                 kf._stream()), "field_dw")
    plan, slices = kf.dw_plan(
        lib, p, mode, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = kf.bwd_dw(lib, bwd, dw, p, mode, n, chunk or plan, slices, dev)
    return dx, dd, kf._dw_reduce(lib, part)


# the K2/K6 backwards that the time phase runs in turns with --parent:
# (raw, mode, need_dw); in transient mode on the fine training pass with
# dW and frozen, frozen in full mode on the refinement's fine pass, with
# dW in full mode on the coarse training pass
_BWD_ENTRY = {"K2 field_bwd_pre +dW": (False, "transient", True),
              "K6 field_bwd +dW": (True, "transient", True),
              "K2 field_bwd_pre transient": (False, "transient", False),
              "K6 field_bwd transient": (True, "transient", False),
              "K2 field_bwd_pre": (False, "full", False),
              "K6 field_bwd": (True, "full", False),
              "K6 field_bwd +dW coarse": (True, "full", True)}


def bwd_args(name, ins):
    """(packed, x, dirs, the four head cotangents) of a _BWD_ENTRY on its
    inputs: with dW the training inputs' fine pass (g_f_raw / g_f_pre) or
    coarse pass (g_c_raw), else the main path's (g_field / g_raw)."""
    raw, mode, need_dw = _BWD_ENTRY[name]
    if mode == "transient":
        x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"],
                                                       ins["embd"])
        return ins["packed"][1], x, xd, ins["g_f_raw" if raw else "g_f_pre"]
    if need_dw:
        return (ins["packed"][0], ins["pts_c"], ins["dirs_c"],
                ins["g_c_raw"][:3] + [None])
    x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"], ins["embd"])
    return (ins["packed"][1], x, xd,
            list(ins["g_raw" if raw else "g_field"]) + [None])


def bwd_call(lib, name, ins, dev, blocks=None):
    """One launch (with dW: one per chunk, each with the dW kernel) of the
    _BWD_ENTRY `name` from `lib`: its outputs, those present."""
    raw, mode, need_dw = _BWD_ENTRY[name]
    p, x, xd, g = bwd_args(name, ins)
    out = field_bwd_call(lib, raw, MODES.index(mode), p, x, xd, g, need_dw,
                         dev, blocks)
    return [o for o in out if o is not None]


def bwd_plain(name, ins):
    """The plain version of the _BWD_ENTRY `name` on the same inputs."""
    from nefes_tpu_torch.kernels import fused_field as kf
    raw, mode, need_dw = _BWD_ENTRY[name]
    p, x, xd, g = bwd_args(name, ins)
    plain = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    g = g if mode == "transient" else g[:3]
    out = plain(p, MODES.index(mode), x, xd, *g, need_dw=need_dw)
    return [o for o in out if o is not None]


# each field forward that the time phase runs in turns: (entry point,
# raw, mode); sigma mode as the main path's coarse pass runs it, transient
# mode as training's fine pass does
_FIELD_ENTRY = {"K1 field_fwd_pre": ("nefes_field_fwd_pre", False, 0),
                "K5 field_fwd": ("nefes_field_fwd_raw", True, 0),
                "K1 field_fwd_pre transient": ("nefes_field_fwd_pre", False,
                                               2),
                "K5 field_fwd transient": ("nefes_field_fwd_raw", True, 2)}


def field_call(lib, name, ins, dev, blocks=None):
    """One launch of K1 or K5 from the fused_field library `lib` (this
    tree's, or an earlier one's, whose forward takes no wt and no blocks)
    with none of the wrapper's checks or launch counts: in sigma mode on
    the main path's coarse pass (`ins` its inputs), in transient mode on
    training's fine pass (`ins` the training inputs). blocks: this tree's
    grid (None: the wrapper's persistent grid, 0: one block per block
    tile). Returns the mode's heads, [sigma] or [sigma, rgb, feat,
    transient]."""
    from nefes_tpu_torch.kernels import fused_field as kf
    fn, raw, mode = _FIELD_ENTRY[name]
    p = ins["packed"][int(mode == kf.TRANSIENT)]
    sp = p.spec
    if mode == kf.SIGMA:
        x, xd = ins["pts_c"] if raw else ins["emb_c"], None
    else:
        x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"],
                                                       ins["embd"])
    n = x.shape[0]
    outs = kf._fwd_outputs(sp, mode, n, torch.float32 if raw
                           else sp.torch_dtype, dev)
    if hasattr(lib, "nefes_field_smem_bytes"):
        if blocks is None:
            blocks = kf.fwd_blocks(lib, p, mode, raw, n, dev)
        weights, tail = (p.w, p.wt, p.b), (blocks,)
    else:
        weights, tail = (p.w, p.b), ()
    err = getattr(lib, fn)(kf._DTYPE_CODE[sp.torch_dtype], mode, n,
                           x.data_ptr(), kf._ptr(xd),
                           *[t.data_ptr() for t in weights], *kf.dims(sp),
                           *[kf._ptr(o) for o in outs], *tail, kf._stream())
    kf.raise_on(err, fn)
    return [o for o in outs if o is not None]


def replace_cfg(cfg, **kw):
    from dataclasses import replace
    return replace(cfg, **kw)


def look_at() -> np.ndarray:
    from nefes_tpu_torch.data.synthetic import look_at_pose
    return look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))


def main_path_inputs(model, pose, dev) -> dict:
    """The kernels' inputs on the refinement's main path, at the true
    pose: every pixel of the H x W render, deterministic samples
    (path_inputs)."""
    from nefes_tpu_torch.geometry.rays import get_rays
    ro, rd = get_rays(H, W, FOCAL, pose[:3, :4])
    return path_inputs(model, ro.reshape(-1, 3), rd.reshape(-1, 3), dev)


def train_poses(dev) -> torch.Tensor:
    """TRAIN_B cameras around the scene, (B, 3, 4)."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    eyes = [(2.4 * np.sin(a), 0.3, 2.4 * np.cos(a))
            for a in np.linspace(0.0, 1.2, TRAIN_B)]
    return torch.from_numpy(np.stack([look_at_pose(np.array(e, np.float32))
                                      for e in eyes])).to(dev)


def train_path_inputs(model, dev) -> dict:
    """The field kernels' inputs on the training path: TRAIN_B images x
    N_RAND random pixels of the H x W render (seed 4), perturbed
    samples."""
    from nefes_tpu_torch.geometry.rays import get_ray_at
    gen = torch.Generator(device=dev).manual_seed(4)
    idx = torch.stack([torch.randperm(H * W, generator=gen, device=dev)
                       [:N_RAND] for _ in range(TRAIN_B)])
    ro, rd = get_ray_at((idx % W).float(), (idx // W).float(), FOCAL, H, W,
                        train_poses(dev))
    return path_inputs(model, ro.reshape(-1, 3), rd.reshape(-1, 3), dev,
                       gen)


def path_inputs(model, ro, rd, dev, gen=None) -> dict:
    """The field kernels' inputs for rays ro, rd (R, 3), made as the
    renderer makes them: coarse points and per-sample directions
    (R·64, 3) with their embeddings (63 and 27), fine points and
    directions (R·128, 3) with theirs, and fine z (R, 128); points and
    directions in f32, embeddings in the model's pack dtype. With `gen`,
    perturbed samples (training), else the deterministic ones."""
    from nefes_tpu_torch.fields.embedder import embed
    from nefes_tpu_torch.kernels.fused_field import field_fwd_pre_plain
    from nefes_tpu_torch.render.compositor import composite
    from nefes_tpu_torch.render.sampling import (
        hierarchical_samples, stratified_samples,
    )
    cfg = model.cfg
    cd = cfg.dtype
    with torch.no_grad():
        packed = model.pack_fused()
        R = ro.shape[0]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        z = stratified_samples(gen, R, N_C, NEAR, FAR,
                               perturb=gen is not None, device=dev)
        pts = ro[:, None] + rd[:, None] * z[..., None]
        emb_c = embed(pts, cfg.xyz_embed).to(cd).reshape(R * N_C, -1)
        sigma = field_fwd_pre_plain(packed[0], False, emb_c, None)[0]
        w = composite({"static_sigma": sigma.reshape(R, N_C)}, z,
                      sigma_only=True, test_time=True)["weights"]
        zf = hierarchical_samples(gen, z, w, N_F, det=gen is None)
        S = zf.shape[1]
        pf = ro[:, None] + rd[:, None] * zf[..., None]
        emb = embed(pf, cfg.xyz_embed).to(cd).reshape(R * S, -1)
        out = dict(packed=packed, emb_c=emb_c.contiguous(),
                   emb=emb.contiguous(), z=zf.contiguous(),
                   pts_c=pts.reshape(-1, 3).contiguous(),
                   pts=pf.reshape(-1, 3).contiguous())
        for key, n_s in (("", S), ("_c", N_C)):
            d = vd[:, None].expand(R, n_s, 3)
            out["embd" + key] = embed(d, cfg.dir_embed).to(cd).reshape(
                R * n_s, -1).contiguous()
            out["dirs" + key] = d.reshape(R * n_s, 3).contiguous()
    return out


def chain(p, mode, emb, embd, backward, dw=False):
    """Yardstick: the tower's matmuls as a plain bf16 torch.matmul chain
    (cuBLAS), forward and, for a backward, the input-gradient products
    and, with dw, one product per weight for its gradient. mode: 0 sigma,
    1 (or True) full, 2 transient."""
    w, spec = p.weights, p.spec
    h, hs = emb, []
    for i in range(spec.depth):
        z = h @ w[f"l{i}_wh" if i else "l0_we"]
        if i and i in spec.skips:
            z = z + emb @ w[f"l{i}_we"]
        h = torch.relu(z)
        hs.append(h)
    out = [h @ w["sig_w"]]
    if mode:
        fin = h @ w["fin_w"]
        de = torch.relu(fin @ w["dir_wh"] + embd @ w["dir_wd"])
        out.append(de @ w["rgb_w"])
    if mode == 2:
        ts = [torch.relu(fin @ w["t1_wh"] + embd @ w["t1_wd"])]
        for n in ("t2", "t3"):
            ts.append(torch.relu(ts[-1] @ w[f"{n}_w"]))
        heads = [ts[-1] @ w[f"{n}_w"] for n in ("ts", "tr", "tb")]
        out += heads
    if not backward:
        return out
    dws = []

    def grad(act, g):
        if dw:
            dws.append(act.t() @ g)

    g = out[1]
    grad(de, g)
    g = g @ w["rgb_w"].t()
    grad(fin, g)
    grad(embd, g)
    g_fin = g @ w["dir_wh"].t()
    g_embd = g @ w["dir_wd"].t()
    if mode == 2:
        gt = sum(hd @ w[f"{n}_w"].t() for hd, n in zip(heads, ("ts", "tr",
                                                             "tb")))
        for hd in heads:
            grad(ts[2], hd)
        for n, act in (("t3", ts[1]), ("t2", ts[0])):
            grad(act, gt)
            gt = gt @ w[f"{n}_w"].t()
        grad(fin, gt)
        grad(embd, gt)
        g_fin = g_fin + gt @ w["t1_wh"].t()
        g_embd = g_embd + gt @ w["t1_wd"].t()
    grad(h, g_fin)
    grad(h, out[0])
    dh = g_fin @ w["fin_w"].t() + out[0] @ w["sig_w"].t()
    d_emb = 0
    for i in range(spec.depth - 1, -1, -1):
        dz = dh * (hs[i] > 0)
        grad(hs[i - 1] if i else emb, dz)
        if i == 0:
            d_emb = d_emb + dz @ w["l0_we"].t()
        else:
            dh = dz @ w[f"l{i}_wh"].t()
            if i in spec.skips:
                grad(emb, dz)
                d_emb = d_emb + dz @ w[f"l{i}_we"].t()
    return d_emb, g_embd, dws


def event_ms(fn) -> float:
    """One call of fn, timed with CUDA events (ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` timed calls (CUDA events) after two warm calls."""
    for _ in range(2):
        fn()
    return statistics.median(event_ms(fn) for _ in range(reps))


if __name__ == "__main__":
    sys.exit(main())
