"""Refinement CLI; port of nefes_tpu/cli/refine.py (the reference's
test_refinement.py).

  python -m nefes_tpu_torch.cli.refine --config <scene_DFM.txt> \
      --pose_only {2,3} [--device cpu]

pose_only=2: APR-weight refinement (the paper's headline,
DFM_APR_refine.py), through the raw-input kernels K5/K7/K8.
--PoseEstimatorType picks the APR: DFNet (the feature extractor's own
checkpoint, or --pretrain_model_path), or one of the zoo (PoseNet,
PoseNetV2, EfficientNetB3, MapNet, MsTransformer) from a reference
checkpoint in --pretrain_model_path (features/apr_loader.py) or seeded
random weights; DFNet stays the feature extractor.
pose_only=3: explicit SE(3)-delta refinement (DFM_pose_refine.py),
through the pre-embedded kernels K1/K3/K4.

On the card each frame replays one captured iteration (refine/graph.py);
with --device cpu the same steps run eagerly on the kernels' plain
versions. The scene's inputs stay on the device when they fit (2 GiB of
target features, as the JAX CLI's rule), and the refined poses are read
back once, after the loop. Writes them in the reference's txt format
(<APR>_<scene>_NeFeS<iters>_APR_pose_results.txt), which
nefes_tpu_torch.cli.evaluate and the reference's eval.py read; returns
the error summary.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from nefes_tpu_torch.cli.options import options_from_cli
from nefes_tpu_torch.cli.train import build_model, build_scene, load_dfnet
from nefes_tpu_torch.evaluation import pose_errors, save_pose_txt, summarize
from nefes_tpu_torch.features import extract_target_features, load_apr
from nefes_tpu_torch.features.convert import convert_nefes_checkpoint
from nefes_tpu_torch.refine import (
    RefineConfig, apply_verification, apr_poses_batched, refine_apr_batch,
    refine_apr_verified, refine_apr_verified_scanned, refine_pose_indexed,
    refine_poses_batch, refine_poses_scanned,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# inputs kept on the device below this many bytes of target features
RESIDENT_BYTES = 2 * 1024 ** 3
# the kernel path of each mode (render configs' fused flags)
KERNEL_PATHS = {
    3: dict(fused=True, fused_pre=True, fused_render=True,
            fused_need_dw=False),                       # K1, K3, K4
    2: dict(fused=True, fused_pre=False, fused_render=True,
            fused_need_dw=False),                       # K5, K7, K8
}


def load_field_weights(opts, model) -> None:
    """A reference .tar (converted), a port checkpoint (torch.save of the
    train state), or, with neither, the model's seeded random weights."""
    if opts.ft_path and opts.ft_path.endswith(".tar"):
        model.load_state_dict(convert_nefes_checkpoint(opts.ft_path,
                                                       depth=opts.netdepth))
    elif opts.ft_path:
        from nefes_tpu_torch.train import create_train_state
        from nefes_tpu_torch.train.checkpoint import restore_checkpoint
        restore_checkpoint(opts.ft_path, create_train_state(model))
    else:
        print("WARNING: no ft_path — random field (smoke mode)")


def nearest_upsample(masks: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, h, w) -> (N, H, W) nearest, source index floor((i + 0.5)·in /
    out) (jax.image.resize's "nearest", as the JAX CLI upsamples), in
    integers: XLA's float32 rounding of an exact tie goes either way,
    and no tie falls on the Cambridge render sizes."""
    def idx(n_in, n_out):
        i = torch.arange(n_out)
        return ((2 * i + 1) * n_in // (2 * n_out)).to(masks.device)
    rows, cols = idx(masks.shape[1], H), idx(masks.shape[2], W)
    return masks[:, rows][:, :, cols]


def _slices(n: int, g: int) -> list[slice]:
    return [slice(i, min(i + g, n)) for i in range(0, n, g)]


def main(argv=None) -> dict:
    opts = options_from_cli(argv)
    if opts.pose_only not in (2, 3):
        raise ValueError("refinement needs --pose_only 2|3")
    if opts.apr_compute_dtype != "float32":
        raise NotImplementedError(
            f"apr_compute_dtype {opts.apr_compute_dtype!r}: DFNet runs in "
            "float32 only; the bf16 DFNet is ROADMAP Queue A item 6 (the "
            "rest of item 14)")
    dev = torch.device(opts.device)

    t_start = time.time()

    def phase(msg):
        print(f"[refine +{time.time() - t_start:.1f}s] {msg}", flush=True)

    scene_name = os.path.basename(opts.datadir.rstrip("/"))
    if opts.load_pose_avg_stats:
        test = build_scene(opts, train=False)
    else:
        # the centring stats of the TRAIN split (the field's frame)
        train_scene = build_scene(opts, train=True)
        test = build_scene(opts, train=False,
                           pose_avg_override=train_scene.pose_avg_stats)
    phase("scene loaded")
    # the field in the refinement's compute dtype (bf16 by default);
    # parameters stay f32
    cfg, model = build_model(opts, dtype=_DTYPES[opts.field_compute_dtype],
                             device=dev,
                             generator=torch.Generator().manual_seed(0))
    load_field_weights(opts, model)
    model.requires_grad_(False)

    # the feature extractor is always DFNet (load_FeatureNet,
    # direct_pose_model.py:109-118)
    if opts.pretrain_featurenet_path:
        dfnet = load_dfnet(opts.pretrain_featurenet_path, opts, dev, 1)
    elif opts.pretrain_model_path and opts.PoseEstimatorType == "DFNet":
        dfnet = load_dfnet(opts.pretrain_model_path, opts, dev, 1)
    else:
        print("WARNING: random DFNet feature extractor (smoke mode)")
        dfnet = load_dfnet("", opts, dev, 1)
    # the pose estimator (load_APR_and_FeatureNet,
    # direct_pose_model.py:148-173)
    pose_avg = getattr(test, "pose_avg_stats", None)
    if opts.PoseEstimatorType != "DFNet":
        apr, _ = load_apr(
            opts.PoseEstimatorType, opts.pretrain_model_path or None,
            (test.H, test.W), torch.Generator().manual_seed(2),
            feature_dim=opts.feature_dim, dataset_type=opts.dataset_type,
            pose_avg_stats=pose_avg, device=dev)
        apr.requires_grad_(False)
    elif opts.pretrain_model_path and opts.pretrain_featurenet_path:
        # distinct APR and FeatureNet checkpoints (config_stairs_DFM.txt)
        apr = load_dfnet(opts.pretrain_model_path, opts, dev, 1)
    else:
        apr = dfnet

    phase("models/weights ready")
    h, w = opts.render_hw(test.H, test.W)
    hwf_render = (h, w, float(test.focal) / opts.tinyscale)
    near, far = test.near, test.far
    if opts.set_near_far:
        near, far = opts.near_far
    rcfg_render = replace(cfg.render_config(
        n_samples=opts.N_samples, n_importance=opts.N_importance,
        perturb=False, test_time=True, output_transient=False, remat=False),
        **KERNEL_PATHS[opts.pose_only])
    rcfg = RefineConfig(opt_iter=opts.opt_iter, lr_r=opts.lr_r,
                        lr_t=opts.lr_t, tinyscale=opts.tinyscale,
                        per_pixel=opts.per_pixel,
                        learning_rate=opts.learning_rate,
                        fusion=opts.fusion_bn)
    ws = test.world
    ws_vec = ws.vec(device=dev)

    n = len(test)
    t0 = time.time()
    masks = test.masks if (opts.semantic and getattr(test, "masks", None)
                           is not None) else None
    images = torch.from_numpy(test.images)
    hists = torch.from_numpy(test.hists).to(dev)
    B = max(1, opts.refine_batch)      # cameras refined in one call
    # scan_frames folds frames into one call, at refine_batch 1
    SF = max(1, opts.scan_frames) if B == 1 else 1
    slices = _slices(n, SF if B == 1 else B)
    refined = []

    def extract(H, W, levels=(0,)):
        """Target features of every frame at (H, W), on the device when
        they fit, else on the host; (targets, resident)."""
        resident = n * H * W * opts.feature_dim * 4 < RESIDENT_BYTES
        out = []
        with torch.no_grad():
            for i in range(0, n, 8):
                f = extract_target_features(dfnet, images[i:i + 8].to(dev),
                                            H, W, levels=levels)
                out.append(f if resident else f.cpu())
        return torch.cat(out), resident

    def staged(x, sl, resident):
        """Slice sl of x on the device (a view when resident)."""
        return x[sl] if resident else x[sl].to(dev)

    if opts.pose_only == 2:
        # level 0 only: the reference's mode 2 matches feature_list[0][0]
        # (DFM_APR_refine.py:222)
        targets, resident = extract(test.H, test.W)
        images_all = images.to(dev) if resident else images
        masks_all = None
        if masks is not None:
            # loader masks are at render scale; the mode-2 loss is at the
            # query's size
            masks_all = nearest_upsample(torch.from_numpy(masks), test.H,
                                         test.W)
            masks_all = masks_all.to(dev) if resident else masks_all
        phase("targets precomputed")
        kw = dict(svd_reg=opts.svd_reg, freeze_bn=opts.freezeBN,
                  apr_kind=opts.PoseEstimatorType,
                  dataset_type=opts.dataset_type, pose_avg=pose_avg)
        verify = dict(use_verification=not opts.no_verification_step,
                      verification_metric=opts.verification_metric)
        hwf_full = (test.H, test.W, float(test.focal))
        common = (ws_vec, hwf_render, hwf_full, near, far, rcfg_render,
                  rcfg)
        for si, sl in enumerate(slices):
            imgs_d = staged(images_all, sl, resident)
            tgts_d = staged(targets, sl, resident)
            masks_d = (None if masks_all is None
                       else staged(masks_all, sl, resident))
            nb = sl.stop - sl.start
            if SF > 1:
                poses = refine_apr_verified_scanned(
                    model, apr, imgs_d, tgts_d, hists, range(nb),
                    range(sl.start, sl.stop), *common, masks=masks_d, **kw,
                    **verify)
            elif B == 1:
                poses = refine_apr_verified(
                    model, apr, imgs_d, tgts_d, hists, 0, sl.start, *common,
                    masks=masks_d, **kw, **verify)[None]
            else:
                out = refine_apr_batch(model, apr, imgs_d, tgts_d,
                                       hists[sl], *common, masks=masks_d,
                                       **kw)
                poses = (out["refined_pose"] if opts.no_verification_step
                         else apply_verification(out,
                                                 opts.verification_metric))
            refined.append(poses)
            if si % max(1, 50 // B) == 0:
                print(f"queued {sl.start}/total {n}", flush=True)
    else:   # pose_only == 3: APR initial poses, then SE(3) refinement
        with torch.no_grad():
            init_poses = torch.cat([
                apr_poses_batched(opts.PoseEstimatorType, apr,
                                  images[i:i + 8].to(dev), opts.svd_reg,
                                  dataset_type=opts.dataset_type,
                                  pose_avg=pose_avg)
                for i in range(0, n, 8)])
        phase("init poses computed")
        if len(opts.feature_matching_lvl) != 1:
            # the rendered features have feature_dim channels: a
            # multi-level target cannot be matched against them
            raise ValueError(
                "feature_matching_lvl must select exactly one level for "
                f"DFM refinement, got {opts.feature_matching_lvl!r}")
        targets, resident = extract(h, w, tuple(opts.feature_matching_lvl))
        masks_all = None if masks is None else torch.from_numpy(masks)
        if masks_all is not None and resident:
            masks_all = masks_all.to(dev)
        phase("targets precomputed")
        for si, sl in enumerate(slices):
            poses_d = init_poses[sl]
            tgts_d = staged(targets, sl, resident)
            masks_d = (None if masks_all is None
                       else staged(masks_all, sl, resident))
            if SF > 1:
                poses = refine_poses_scanned(
                    model, poses_d, tgts_d, hists[sl], ws, hwf_render,
                    rcfg_render, rcfg, masks=masks_d)
            elif B == 1:
                # the JAX CLI passes ws.near / ws.far here, not the
                # set_near_far values of mode 2 (ROADMAP Queue C)
                poses = refine_pose_indexed(
                    model, poses_d, tgts_d, hists[sl], 0, ws_vec,
                    hwf_render, ws.near, ws.far, rcfg_render, rcfg,
                    masks=masks_d)[None]
            else:
                poses, _ = refine_poses_batch(
                    model, poses_d, tgts_d, hists[sl], ws, hwf_render,
                    rcfg_render, rcfg, masks=masks_d)
            refined.append(poses)
            if si % max(1, 50 // B) == 0:
                print(f"queued {sl.start}/total {n}", flush=True)
    out_poses = torch.cat(refined).cpu().numpy()      # the one read-back
    phase("refinement drained")
    results = pose_errors(out_poses, test.poses)

    dt = time.time() - t0
    s = summarize(results)
    print(f"Total execution time = {dt:.3f} sec "
          f"({dt / max(n, 1):.3f} s/frame)")
    print(f"Median error {s['median_t_m']}m and {s['median_r_deg']} degrees.")
    print(f"Mean error {s['mean_t_m']}m and {s['mean_r_deg']} degrees.")

    save_dir = opts.save_dir or (
        f"tmp/{opts.PoseEstimatorType}_NeFeS{opts.opt_iter}_"
        f"{opts.dataset_type}/{scene_name}")
    os.makedirs(save_dir, exist_ok=True)
    out_txt = (f"{save_dir}/{opts.PoseEstimatorType}_{scene_name}_"
               f"NeFeS{opts.opt_iter}_APR_pose_results.txt")
    save_pose_txt(out_txt, out_poses)
    print(f"saved {out_txt}")
    return s


if __name__ == "__main__":
    main()
