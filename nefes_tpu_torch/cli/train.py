"""NeFeS field-training CLI (the reference's run_nefes.py); port of
nefes_tpu/cli/train.py, whose builders the refinement CLI shares.

  python -m nefes_tpu_torch.cli.train --config <scene_config.txt> \
      [--flag value ...] [--device cpu]

Takes the JAX CLI's flags and the reference's per-scene config txts
(script/config/**). The three-stage schedule is run_nefes.py:34-40's:
a stage-1 run (new_schedule 1) trains colour only for `epochs`; a
stage-2 run (new_schedule 2, from --ft_path) trains colour + features
until epoch 200, then colour + features + fusion on patches. Writes
args.txt, metrics.jsonl (every i_print epochs), checkpoints
(ckpts/epoch_<n>.pt, every i_weights), the validation renders
(evaluate_{train,val}_<step>/, every i_testset) and, with
--render_video_{train,test}, their mp4s; --render_test evaluates the
restored checkpoint and exits, --render_pose_only writes a spiral video
and exits, --profile_dir traces the first epoch (torch.profiler).

On the card every pass of the NeRFH-NFF field runs through the kernels
(KERNEL_PATHS); with --device cpu the same code runs their plain
versions. A zoo field (--tcnn, --sh_nff, --ffmlp, --nerfh_nff False,
--NeRFW False; train/field_zoo.py) trains and renders in plain PyTorch
on the same device, as the JAX package renders it outside Pallas; it
takes no feature or fusion loss. The field trains in f32, as the JAX
CLI's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from nefes_tpu_torch.cli.options import options_from_cli
from nefes_tpu_torch.data import (
    load_7scenes_colmap, load_7scenes_dslam, load_cambridge,
)
from nefes_tpu_torch.features.dfnet import DFNet, extract_target_features
from nefes_tpu_torch.fields.embedder import EmbedConfig, train_windows
from nefes_tpu_torch.render.validation import (
    holdout_views, render_spiral_video, render_test,
)
from nefes_tpu_torch.train.field_zoo import build_zoo_model
from nefes_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
from nefes_tpu_torch.train.trainer import (
    AuxConfig, create_train_state, lr_for_epoch, make_optimizer,
    stage_for_epoch, train_step_patch, train_step_rays,
)
from nefes_tpu_torch.utils.image import resize_bilinear
from nefes_tpu_torch.utils.init import lecun_normal_
from nefes_tpu_torch.utils.profiling import trace

# the field kernels of each render (RenderConfig's fused flags). Training
# runs the raw-input kernels with weight gradients (K5, K6 +dW, each K6
# chunk followed by the dW kernel), the validation renders the frozen K5.
# Under the Nerfies window (reduce_embedding=2) the embedding stays in
# PyTorch, where the window is applied, and the pre-embedded kernels run
# (K1, K2 +dW; K1): the raw-input kernels embed inside and cannot window.
KERNEL_PATHS = {
    "train": dict(fused=True, fused_pre=False, fused_need_dw=True),
    "train_windowed": dict(fused=True, fused_pre=True, fused_need_dw=True),
    "test": dict(fused=True, fused_pre=False, fused_need_dw=False),
    "test_windowed": dict(fused=True, fused_pre=True, fused_need_dw=False),
}
TARGET_CHUNK = 8   # images DFNet and the resize take at once


def build_scene(opts, train: bool, pose_avg_override=None):
    """The split of opts.datadir's scene (dataset_type 7Scenes_colmap,
    7Scenes or Cambridge)."""
    scene = os.path.basename(opts.datadir.rstrip("/"))
    root = os.path.dirname(opts.datadir.rstrip("/"))
    common = dict(train=train, trainskip=opts.trainskip,
                  testskip=opts.testskip, df=opts.df, hist_bin=opts.hist_bin,
                  load_pose_avg_stats=opts.load_pose_avg_stats,
                  pose_avg_override=pose_avg_override)
    if opts.dataset_type == "7Scenes_colmap":
        return load_7scenes_colmap(scene, root, opts.data_root, **common)
    if opts.dataset_type == "7Scenes":
        return load_7scenes_dslam(scene, root, opts.data_root, **common)
    if opts.dataset_type == "Cambridge":
        return load_cambridge(scene, root, semantic=opts.semantic,
                              tinyscale=opts.tinyscale, **common)
    raise ValueError(f"unknown dataset_type {opts.dataset_type!r}")


def embed_configs(opts) -> tuple[EmbedConfig, EmbedConfig]:
    """(xyz, dir) embeddings of reduce_embedding: 0 halves the frequency
    bands, 1 is the identity; otherwise multires / multires_views bands
    (2, the Nerfies window, anneals them in training only)."""
    if opts.reduce_embedding == 0:
        return tuple(EmbedConfig(num_freqs=m // 2, max_freq_log2=(m - 1) // 2)
                     for m in (opts.multires, opts.multires_views))
    if opts.reduce_embedding == 1:
        ident = EmbedConfig(num_freqs=0, max_freq_log2=0)
        return ident, ident
    return (EmbedConfig(num_freqs=opts.multires),
            EmbedConfig(num_freqs=opts.multires_views))


def is_zoo_field(opts) -> bool:
    """True when the flags select a field other than NeRFH-NFF (reference
    create_nerf's dispatch, models/options.py:43-48, nerfh.py:539-552)."""
    return (opts.tcnn or opts.sh_nff or opts.ffmlp
            or not opts.nerfh_nff or not opts.NeRFW)


def build_model(opts, dtype: torch.dtype = torch.float32, device="cuda",
                generator: torch.Generator | None = None):
    """(ModelConfig, NeFeSModel on device) of the flags, or (ZooConfig,
    ZooFieldModel) for a zoo field (f32 whatever dtype, as the JAX
    package's); the model's weights are random (from `generator` where
    given) until loaded."""
    if is_zoo_field(opts):
        return build_zoo_model(opts, device=device, generator=generator)
    xyz, dirs = embed_configs(opts)
    cfg = ModelConfig(depth=opts.netdepth, width=opts.netwidth,
                      feature_dim=opts.feature_dim,
                      fusion_residual=opts.use_fusion_res,
                      fusion_no_bn=opts.no_fusion_BN,
                      hist_bin=opts.hist_bin, encode_hist=opts.encode_hist,
                      xyz_embed=xyz, dir_embed=dirs, dtype=dtype)
    return cfg, NeFeSModel(cfg, device=device, generator=generator)


def init_train_model(opts, device):
    """(config, model) that training starts from, f32, before any
    checkpoint is loaded: flax's initialisers (lecun_normal weights, zero
    biases) drawn from a seeded generator, as the JAX CLI's
    create_train_state(model, key(0)) draws them; a zoo field draws its
    own (train/field_zoo.py)."""
    gen = torch.Generator().manual_seed(0)
    if is_zoo_field(opts):
        return build_model(opts, device=device, generator=gen)
    cfg, model = build_model(opts, device=device)
    lecun_normal_(model, gen)
    return cfg, model


def load_dfnet(path: str, opts, dev, seed: int,
               dtype: torch.dtype = torch.float32) -> DFNet:
    """DFNet computing in dtype (parameters f32) from a reference
    checkpoint, or seeded random weights when path is empty; frozen."""
    from nefes_tpu_torch.features.convert import (
        convert_dfnet, load_torch_state_dict,
    )
    dfnet = DFNet(output_dim=opts.feature_dim, dtype=dtype, device=dev,
                  generator=torch.Generator().manual_seed(seed))
    if path:
        dfnet.load_state_dict(convert_dfnet(load_torch_state_dict(path)))
    return dfnet.requires_grad_(False)


def window_for_epoch(opts, cfg: ModelConfig, epoch: int, device=None):
    """The Nerfies coarse-to-fine band weights of reduce_embedding=2 at an
    epoch (reference embed_DNeRF and its i_epoch, run_nefes.py:370-371);
    None for every other mode."""
    if opts.reduce_embedding != 2:
        return None
    n_full = (opts.epochToMaxFreq if opts.epochToMaxFreq > 0
              else max(opts.epochs, 1))
    return train_windows(float(epoch), cfg.xyz_embed, cfg.dir_embed, n_full,
                         device)


@torch.no_grad()
def precompute_targets(opts, scene, dfnet: DFNet | None, device):
    """The target rgb of every training image at the render size, and
    DFNet's features of it there when dfnet is given, f32 on the host
    (DFNet is frozen: computed once a run, not once a batch as the
    reference does, run_nefes.py:137-139). Returns (rgb, feats | None)."""
    h, w = opts.render_hw(scene.H, scene.W)
    rgb, feats = [], []
    for i in range(0, len(scene.images), TARGET_CHUNK):
        imgs = torch.from_numpy(np.asarray(
            scene.images[i:i + TARGET_CHUNK], np.float32)).to(device)
        rgb.append(resize_bilinear(imgs, h, w).cpu())
        if dfnet is not None:
            feats.append(extract_target_features(dfnet, imgs, h, w).cpu())
    return torch.cat(rgb), (torch.cat(feats) if dfnet is not None else None)


def main(argv=None):
    opts = options_from_cli(argv)
    dev = torch.device(opts.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the training CLI runs on the "
                           "card (--device cpu runs the kernels' plain "
                           "versions on the CPU)")
    zoo = is_zoo_field(opts)
    needs_feat = (opts.new_schedule == 2 or opts.color_feat_loss
                  or opts.color_feat_fusion_loss
                  or opts.color_feat_fusion_nerfw_loss)
    if zoo and needs_feat:
        raise ValueError(
            "feature/fusion losses need the NeRFH-NFF field's feature head; "
            "the selected zoo field is color-only — train it with "
            "new_schedule=1 (the reference's legacy fields are likewise "
            "outside the run_nefes feature schedule)")

    scene = build_scene(opts, train=True)
    cfg, model = init_train_model(opts, dev)
    state = create_train_state(
        model, make_optimizer(model.parameters(), grad_clip=opts.grad_clip))

    expdir = os.path.join(opts.basedir, opts.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, "args.txt"), "w") as f:
        for k in sorted(vars(opts)):
            f.write(f"{k} = {getattr(opts, k)}\n")

    ckpt = None if opts.no_reload else latest_checkpoint(
        os.path.join(expdir, "ckpts"))
    if opts.ft_path:
        ckpt = opts.ft_path
    if ckpt:
        print(f"restoring from {ckpt}")
        state = restore_checkpoint(ckpt, state)
        if (opts.new_schedule == 2 and not opts.render_test
                and ckpt == opts.ft_path):
            # only on the explicit fine-tune entry (ft_path): a resumed
            # stage-2 run keeps its clock and optimizer. The stage-2
            # schedule counts epochs from 0 (run_nefes.py:323-326) and the
            # reference never reloads the optimizer (nerfh_nff.py:703-705)
            state.epoch = 0
            state.tx = make_optimizer(model.parameters(),
                                      grad_clip=opts.grad_clip)
            print("new_schedule=2: reset epoch=0 + fresh optimizer "
                  "for fine-tuning")

    # the frozen DFNet of the feature targets (stages 1-2)
    dfnet = None
    if needs_feat:
        if not opts.pretrain_featurenet_path:
            print("WARNING: no pretrain_featurenet_path — random DFNet")
        dfnet = load_dfnet(opts.pretrain_featurenet_path, opts, dev, 1)

    target_rgb, target_feat = precompute_targets(opts, scene, dfnet, dev)
    h, w = opts.render_hw(scene.H, scene.W)
    hwf = (h, w, float(scene.focal) / opts.tinyscale)
    near, far = scene.near, scene.far
    if opts.set_near_far:
        near, far = opts.near_far

    samples_per_step = (opts.batch_size * opts.N_rand
                        * (2 * opts.N_samples + opts.N_importance))
    remat = {"on": True, "off": False}.get(
        opts.remat, samples_per_step > 4_000_000)
    windowed = opts.reduce_embedding == 2
    rcfg = cfg.render_config(
        n_samples=opts.N_samples, n_importance=opts.N_importance,
        perturb=opts.perturb > 0, raw_noise_std=opts.raw_noise_std,
        use_fine_only=opts.use_fine_only, remat=remat,
        output_transient=opts.NeRFW,
        transient_at_test=opts.transient_at_test)
    rcfg_test = rcfg.test()
    if not zoo:
        # the kernels serve the NeRFH-NFF field; a zoo field renders
        # plain PyTorch on the same device (the JAX package renders it
        # outside Pallas too)
        rcfg_test = replace(rcfg_test, **KERNEL_PATHS[
            "test_windowed" if windowed else "test"])
        rcfg = replace(rcfg, **KERNEL_PATHS[
            "train_windowed" if windowed else "train"])
    full_hwf = (scene.H, scene.W, float(scene.focal))

    val_cache: list = []

    def run_validation(step):
        if not val_cache:   # the test split, loaded once
            # in the train split's world frame: share its centring pose
            # when the stats were computed rather than loaded
            override = (None if opts.load_pose_avg_stats
                        else scene.pose_avg_stats)
            val_cache.append(build_scene(opts, train=False,
                                         pose_avg_override=override))
        val_scene = val_cache[0]
        return render_test(
            model, holdout_views(scene, skip=10, limit=opts.val_views),
            holdout_views(val_scene, skip=max(1, len(val_scene)
                                              // max(opts.val_views, 1)),
                          limit=opts.val_views),
            full_hwf, near, far, rcfg_test, dfnet, step,
            basedir=opts.basedir, expname=opts.expname,
            tinyscale=opts.tinyscale, with_feature=dfnet is not None,
            window=window_for_epoch(opts, cfg, step, dev),
            render_video=(opts.render_video_train, opts.render_video_test))

    if opts.render_pose_only:
        # spiral-video entry (reference --render_pose_only, options.py:19)
        path = render_spiral_video(
            model, scene, full_hwf, near, far, rcfg_test,
            os.path.join(expdir, f"{opts.expname}_spiral.mp4"),
            n_views=opts.spiral_views,
            window=window_for_epoch(opts, cfg, state.epoch, dev))
        print(f"saved spiral video {path}")
        return state

    if opts.render_test:
        # render-only entry (reference run_nefes.py:328-333)
        run_validation(state.epoch)
        return state

    aux_cfg = AuxConfig.from_options(opts, far)
    if opts.l1normloss and not (zoo and cfg.kind == "hash"):
        print("WARNING: l1normloss regularises hash-grid tables; ignored "
              "for this field (select the hash field with --tcnn)")
        aux_cfg = replace(aux_cfg, l1normloss=False)
    target_depth = None
    if opts.depth_loss:
        if scene.depths is None:
            print("WARNING: depth_loss set but the dataset carries no "
                  "dpt depth targets (Cambridge train/dpt); ignored")
            aux_cfg = replace(aux_cfg, depth=False)
        else:
            target_depth = resize_bilinear(
                torch.from_numpy(np.asarray(scene.depths, np.float32))[
                    ..., None], h, w)[..., 0]

    n = len(scene)
    gen = torch.Generator(device=dev).manual_seed(0)
    order_rng = np.random.default_rng(0)
    poses = torch.from_numpy(np.asarray(scene.poses, np.float32))
    hists = torch.from_numpy(np.asarray(scene.hists, np.float32))
    masks = (torch.from_numpy(np.asarray(scene.masks, np.float32))
             if opts.semantic and scene.masks is not None else None)
    print(f"training {opts.expname}: {n} views at {h}x{w}, "
          f"schedule={opts.new_schedule}, epochs={opts.epochs}")

    profile_epoch = state.epoch  # the first epoch is traced when asked
    t0 = time.time()
    for epoch in range(state.epoch, opts.epochs + 1):
        stage = (0 if opts.color_loss_only
                 else stage_for_epoch(opts.new_schedule, epoch))
        lr = lr_for_epoch(epoch, opts.lrate, opts.lrate_decay)
        perm = order_rng.permutation(n)
        window = window_for_epoch(opts, cfg, epoch, dev)
        epoch_trace = (trace(opts.profile_dir)
                       if opts.profile_dir and epoch == profile_epoch
                       else contextlib.nullcontext())
        with epoch_trace:
            for i in range(0, n - opts.batch_size + 1, opts.batch_size):
                idx = torch.from_numpy(perm[i:i + opts.batch_size])
                batch = {"rgb": target_rgb[idx].to(dev),
                         "poses": poses[idx].to(dev),
                         "hists": hists[idx].to(dev)}
                if stage >= 1:
                    batch["feat"] = target_feat[idx].to(dev)
                if masks is not None:
                    batch["mask"] = masks[idx].to(dev)
                if target_depth is not None:
                    batch["depth"] = target_depth[idx].to(dev)
                if stage == 2:
                    state, loss, aux = train_step_patch(
                        state, rcfg, batch, gen, lr, hwf, near, far,
                        window=window)
                else:
                    state, loss, aux = train_step_rays(
                        state, rcfg, batch, gen, lr, hwf, near, far,
                        n_rand=opts.N_rand, stage=stage, aux=aux_cfg,
                        window=window)
        state.epoch = epoch + 1

        if epoch % opts.i_print == 0:
            print(f"[epoch {epoch}] stage={stage} loss={float(loss):.5f} "
                  f"psnr={float(aux['psnr']):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            with open(os.path.join(expdir, "metrics.jsonl"), "a") as f:
                rec = {"epoch": epoch, "stage": stage, "loss": float(loss),
                       "wall_s": round(time.time() - t0, 1)}
                rec.update({k: float(v) for k, v in aux.items()})
                f.write(json.dumps(rec) + "\n")
        if epoch % opts.i_weights == 0 and epoch > 0:
            path = save_checkpoint(os.path.join(expdir, "ckpts"), state,
                                   epoch)
            print(f"saved {path}")
        if opts.i_testset > 0 and epoch % opts.i_testset == 0 and epoch > 0:
            run_validation(epoch)
    print("done")
    return state


if __name__ == "__main__":
    main()
