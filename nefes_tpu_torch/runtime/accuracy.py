"""The pieces of the probe's accuracy pipeline; port of the pieces of
runtime/probe.py cmd_accuracy (the JAX package's harness, :429-1223),
which nefes_tpu_torch/runtime/probe.py's cmd_accuracy strings together:

  split_views             the test split (every step-th view from 2) and
                          the train split (:482-485)
  run_stages              the three-stage field schedule: stage 0 colour,
                          stage 1 + features (random rays), stage 2 +
                          fusion (patches) (:526-558)
  render_contrastive_set  full-size RGB renders of the frozen field at
                          each training pose and at pose-perturbed ones
                          (:601-630)
  contrastive_loss        the DFNet finetuning loss: mean(pos) +
                          mean(max(0, margin + pos - min(neg))) (:655-678)
  finetune_dfnet          optax.adam over the trainable DFNet subset
                          (:632-691)
  reset_fusion            the collapse guard's fresh FusionNet (:736-741)
  feature_cos_eval        fused / raw feature quality on views (:771-790)
  apr_loss, train_apr     the augmented DFNet APR and its AdamW under a
                          cosine decay (:825-880)
  dfm_losses_at           the DFM loss at a pose, fused (batch and running
                          BN statistics) and raw (:918-940)
  run_refine              one mode-2 configuration over the test frames,
                          with the verification fail-safe (:979-1011)
  landscape_summary, relief, verification_confusion, proxy_comparison,
  best_mode3              the result's summary statistics

Every render, training step and refinement goes through the names bound
here (train_step_rays, train_step_patch, render_feature_image,
refine_apr_batch, refine_poses_batch), so that a caller can count each
stage's kernel launches by wrapping them in this module. With the fused
flags of a render configuration the field runs through the kernels on a
CUDA tensor and through their plain versions on a CPU one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nefes_tpu_torch.evaluation import pose_errors
from nefes_tpu_torch.features.dfnet import (
    VGG16_PLAN, extract_target_features,
)
from nefes_tpu_torch.geometry import learn_pose
from nefes_tpu_torch.refine import (
    RefineConfig, apply_verification, refine_apr_batch, refine_poses_batch,
    render_feature_image,
)
from nefes_tpu_torch.refine.losses import _cos, feature_cosine_loss
from nefes_tpu_torch.train.model import NeFeSModel
from nefes_tpu_torch.train.trainer import (
    Adam, lr_for_epoch, train_step_patch, train_step_rays,
)
from nefes_tpu_torch.utils.image import resize_bicubic
from nefes_tpu_torch.utils.init import lecun_normal_

TINY = 4            # the field renders at H/4 x W/4
BATCH = 4           # field training: images a step
FT_BATCH = 4        # DFNet finetuning: (real, positive, negatives) a step
APR_BATCH = 8       # APR training: images a step, without replacement
BLOCK_RAYS = 4800   # rays a block of a full-size render
CROP = 10           # the DFM loss's border crop
FIELD_LR, FIELD_LR_DECAY = 5e-4, 0.5
APR_WEIGHT_DECAY, APR_ALPHA = 1e-4, 0.02
JITTER = (0.92, 1.08)   # brightness scale of the APR's augmentation
NOISE_STD = 0.005       # its additive Gaussian noise
# the DFNet's top-level parameter groups under their JAX names, which the
# port's modules carry (weights.dfnet_from_jax_variables maps each one to
# the module of that name)
DFNET_GROUPS = tuple(item[0] for item in VGG16_PLAN if item != "M") + (
    "adapt_0", "adapt_1", "adapt_2", "fc_pose")


def split_views(n_train: int, n_test: int) -> tuple:
    """(train_idx, test_idx) into n_train + n_test views: every
    (n_train + n_test) // n_test-th view from the third is a test view."""
    idx = np.arange(n_train + n_test)
    step = (n_train + n_test) // n_test
    test_idx = idx[2::step][:n_test]
    return np.setdiff1d(idx, test_idx)[:n_train], test_idx


# --------------------------------------------------------------------------
# field training
# --------------------------------------------------------------------------

def run_stages(state, rcfg, data: dict, stage_epochs, ep_global: int,
               order: np.random.Generator, gen: torch.Generator,
               hwf: tuple, near: float, far: float):
    """Train state's model (in place) for each (stage, epochs) of
    stage_epochs from epoch ep_global: per epoch the learning rate
    lr_for_epoch(epoch, 5e-4, 0.5) and batches of BATCH training views in
    order.permutation(data["train_idx"]); stages 0 and 1 random-ray steps
    of min(1024, h·w) rays an image, stage 2 patch steps. data: rgb (N, h,
    w, 3), poses, hists and, from stage 1, feats (N, h, w, F), on the
    model's device. Returns (the last step's metrics, the next epoch)."""
    h, w, _ = hwf
    dev = data["rgb"].device
    n = len(data["train_idx"])
    metrics = None
    for stage, n_ep in stage_epochs:
        for _ in range(n_ep):
            lr = lr_for_epoch(ep_global, FIELD_LR, FIELD_LR_DECAY)
            perm = order.permutation(data["train_idx"])
            for i in range(0, n - BATCH + 1, BATCH):
                sel = torch.from_numpy(perm[i:i + BATCH]).to(dev)
                batch = {k: data[k][sel] for k in ("rgb", "poses", "hists")}
                if stage >= 1:
                    batch["feat"] = data["feats"][sel]
                if stage == 2:
                    _, loss, metrics = train_step_patch(
                        state, rcfg, batch, gen, lr, hwf, near, far)
                else:
                    _, loss, metrics = train_step_rays(
                        state, rcfg, batch, gen, lr, hwf, near, far,
                        n_rand=min(1024, h * w), stage=stage)
            if ep_global % 25 == 0:
                parts = " ".join(f"{k}={float(v):.4f}"
                                 for k, v in metrics.items() if k != "psnr")
                print(f"epoch {ep_global} stage={stage} loss={float(loss):.4f}"
                      f" psnr={float(metrics['psnr']):.2f} {parts}",
                      flush=True)
            ep_global += 1
    return metrics, ep_global


def reset_fusion(model: NeFeSModel, seed: int = 17) -> None:
    """Give model a fresh FusionNet: its convs drawn from seed with flax's
    initialisers, its BN's affine and running statistics reset."""
    lecun_normal_(model.fusion, torch.Generator().manual_seed(seed))
    for mod in model.fusion.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_parameters()


# --------------------------------------------------------------------------
# contrastive DFNet finetuning
# --------------------------------------------------------------------------

def perturbed_pose(pose34: torch.Tensor, rng: np.random.Generator,
                   scale: float) -> torch.Tensor:
    """pose34 moved by a rotation ~ N(0, scale·2°/1.7) and a translation ~
    N(0, scale·5 cm/1.7) a component (drawn from rng in that order)."""
    dr = rng.normal(0, scale * np.deg2rad(2.0) / 1.7, 3)
    dt = rng.normal(0, scale * 0.05 / 1.7, 3)
    f32 = dict(dtype=torch.float32, device=pose34.device)
    return learn_pose(torch.as_tensor(dr, **f32), torch.as_tensor(dt, **f32),
                      pose34)[:3, :4]


@torch.no_grad()
def render_contrastive_set(model, cfg, poses, hists, hwf: tuple, near: float,
                           far: float, neg_scales, rng: np.random.Generator
                           ) -> tuple:
    """The frozen field's exposure-corrected RGB at each pose (N, 3, 4)
    (the positives) and at one perturbed_pose of each scale of neg_scales
    (the negatives), rendered at hwf in blocks of BLOCK_RAYS rays. Returns
    (pos (N, H, W, 3), neg (N, len(neg_scales), H, W, 3)), f32."""
    packed = model.pack_fused() if cfg.fused else None

    def rgb_at(pose, hist):
        # the rgb alone: FusionNet, which the JAX command runs and drops,
        # does not touch it
        rgb, _ = render_feature_image(model, pose, hist, hwf, near, far, cfg,
                                      block_rays=BLOCK_RAYS,
                                      fusion_bn="none", packed=packed)
        return rgb.float()
    pos, negs = [], [[] for _ in neg_scales]
    for pose, hist in zip(poses, hists):
        pos.append(rgb_at(pose, hist))
        for si, sc in enumerate(neg_scales):
            negs[si].append(rgb_at(perturbed_pose(pose, rng, sc), hist))
    return torch.stack(pos), torch.stack([torch.stack(x) for x in negs], 1)


def frame_cosine_losses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """feature_cosine_loss (per channel over the pixels) of each frame of
    (..., H, W, C) feature maps, broadcast over the leading dims."""
    a = a.reshape(*a.shape[:-3], -1, a.shape[-1])
    b = b.reshape(*b.shape[:-3], -1, b.shape[-1])
    return 1.0 - _cos(a, b, dim=-2).mean(-1)


def contrastive_loss(dfnet, imgs: torch.Tensor, pos: torch.Tensor,
                     neg: torch.Tensor, fh: int, fw: int,
                     margin: float) -> torch.Tensor:
    """imgs, pos (B, H, W, 3) and neg (B, S, H, W, 3) through dfnet in one
    batch, level-0 features at (fh, fw): mean over B of the positive's
    cosine loss plus the hinge max(0, margin + pos - min over S of the
    negatives' loss)."""
    B, S = neg.shape[:2]
    f = extract_target_features(dfnet, torch.cat([imgs, pos,
                                                  neg.flatten(0, 1)]), fh, fw)
    f_real, f_pos, f_neg = f[:B], f[B:2 * B], f[2 * B:].unflatten(0, (B, S))
    l_pos = frame_cosine_losses(f_real, f_pos)
    l_neg = frame_cosine_losses(f_real[:, None], f_neg)
    # jnp.maximum and jnp.min split a tie's gradient, as these do
    hinge = torch.maximum(torch.zeros_like(l_pos),
                          margin + l_pos - l_neg.amin(1))
    return l_pos.mean() + hinge.mean()


def trainable_groups(feat_train: str) -> tuple:
    """The DFNet parameter groups the finetuning trains: the adapt blocks
    ("adapt"), or every group but fc_pose ("all")."""
    if feat_train == "adapt":
        return tuple(g for g in DFNET_GROUPS if g.startswith("adapt"))
    return tuple(g for g in DFNET_GROUPS if g != "fc_pose")


def finetune_dfnet(dfnet, imgs: torch.Tensor, pos: torch.Tensor,
                   neg: torch.Tensor, steps: int, lr: float, margin: float,
                   feat_train: str, gen: torch.Generator, fh: int,
                   fw: int) -> None:
    """steps optax.adam(lr) steps (in place) on contrastive_loss over
    dfnet's trainable_groups, each on FT_BATCH triplets drawn from gen
    with replacement."""
    params = [p for g in trainable_groups(feat_train)
              for p in getattr(dfnet, g).parameters()]
    dfnet.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    opt = Adam(params)
    dev = imgs.device
    for stp in range(steps):
        sel = torch.randint(0, imgs.shape[0], (FT_BATCH,), generator=gen,
                            device=gen.device).to(dev)
        opt.zero_grad()
        loss = contrastive_loss(dfnet, imgs[sel], pos[sel], neg[sel], fh, fw,
                                margin)
        loss.backward()
        opt.step(lr)
        if stp % 50 == 0:
            print(f"feat-ft step {stp} loss={loss.item():.4f}", flush=True)
    opt.zero_grad()
    dfnet.requires_grad_(False)


# --------------------------------------------------------------------------
# feature quality and the DFM landscape
# --------------------------------------------------------------------------

def _fused_both(model, rgb_img, raw) -> tuple:
    """FusionNet's output on batch and on running BN statistics."""
    return tuple(model.apply_fusion(rgb_img[None], raw[None], bn_stats=bn)[0]
                 for bn in ("batch", "running"))


@torch.no_grad()
def feature_cos_eval(model, cfg, poses, hists, feats, hwf: tuple,
                     near: float, far: float) -> tuple:
    """Per view (poses (N, 3, 4), hists, feats (N, h, w, F) targets): the
    per-pixel cosine loss of the fused features (batch and running BN
    statistics) and of the raw rendered ones against the target. Returns
    three lists (fused, fused running, raw)."""
    packed = model.pack_fused() if cfg.fused else None
    cols = ([], [], [])
    for pose, hist, tgt in zip(poses, hists, feats):
        rgb_img, raw = render_feature_image(model, pose, hist, hwf, near, far,
                                            cfg, fusion_bn="none",
                                            packed=packed)
        for col, f in zip(cols, (*_fused_both(model, rgb_img, raw), raw)):
            col.append(float(feature_cosine_loss(f, tgt, per_pixel=True)))
    return cols


@torch.no_grad()
def render_views(model, cfg, poses, hists, hwf: tuple, near: float,
                 far: float) -> tuple:
    """(rgb (N, h, w, 3), raw features (N, h, w, F)) of the views."""
    packed = model.pack_fused() if cfg.fused else None
    outs = [render_feature_image(model, p, hi, hwf, near, far, cfg,
                                 fusion_bn="none", packed=packed)
            for p, hi in zip(poses, hists)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


@torch.no_grad()
def dfm_losses_at(model, cfg, pose34, hist, target, hwf: tuple,
                  full_hw: tuple, near: float, far: float,
                  packed=None) -> list:
    """[fused on batch statistics, raw, fused on running statistics]: the
    DFM loss at pose34 of one render, each feature map bicubic-upsampled to
    full_hw and cropped by CROP against the cropped target."""
    rgb_img, raw = render_feature_image(model, pose34, hist, hwf, near, far,
                                        cfg, fusion_bn="none", packed=packed)
    fused, fused_run = _fused_both(model, rgb_img, raw)
    out = []
    for f in (fused, raw, fused_run):
        up = resize_bicubic(f[None], *full_hw)[0]
        out.append(float(feature_cosine_loss(
            up[CROP:-CROP, CROP:-CROP], target[CROP:-CROP, CROP:-CROP])))
    return out


def relief(at_init: np.ndarray, at_gt: np.ndarray, col: int) -> float:
    """How much lower the median DFM loss is at the true pose than at the
    APR's, in % of the latter (column col of the (N, 3) losses)."""
    med_i = float(np.median(at_init[:, col]))
    med_g = float(np.median(at_gt[:, col]))
    return round(100.0 * (med_i - med_g) / max(med_i, 1e-9), 2)


def landscape_summary(at_init: np.ndarray, at_gt: np.ndarray) -> dict:
    """The landscape keys of the result from the (N, 3) DFM losses
    [fused batch, raw, fused running] at the APR and at the true poses:
    the medians, the reliefs of raw and fused running, and the frames'
    shares whose loss is lower at the true pose (fused, raw)."""
    out = {}
    for col, name in ((0, "fused"), (1, "raw"), (2, "fused_running")):
        out[f"dfm_loss_at_init_{name}"] = float(np.median(at_init[:, col]))
        out[f"dfm_loss_at_gt_{name}"] = float(np.median(at_gt[:, col]))
    out["dfm_relief_raw_pct"] = relief(at_init, at_gt, 1)
    out["dfm_relief_fused_running_pct"] = relief(at_init, at_gt, 2)
    out["frames_gt_lower_fused_frac"] = float(
        np.mean(at_gt[:, 0] < at_init[:, 0]))
    out["frames_gt_lower_raw_frac"] = float(
        np.mean(at_gt[:, 1] < at_init[:, 1]))
    return out


# --------------------------------------------------------------------------
# the DFNet APR
# --------------------------------------------------------------------------

def augment(imgs: torch.Tensor, scale: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """Brightness scale (B, 1, 1, 1) and NOISE_STD · noise, in [0, 1]."""
    return torch.clamp(imgs * scale + NOISE_STD * noise, 0.0, 1.0)


def apr_loss(apr, imgs: torch.Tensor, gt12: torch.Tensor,
             scale: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the APR's 12-vector pose of the augmented
    images against gt12 (B, 12)."""
    _, pose12 = apr(augment(imgs, scale, noise), return_feature=False,
                    return_pose=True)
    return torch.mean((pose12 - gt12) ** 2)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule: count -> init_value · ((1 - alpha) ·
    (1 + cos(π · min(count, decay_steps) / decay_steps)) / 2 + alpha)."""
    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)
    return schedule


class AdamW(Adam):
    """optax.adamw(schedule, weight_decay): the Adam direction plus
    weight_decay times the parameter, the sum scaled by -schedule(count)
    with count the steps taken before this one. A parameter without a
    gradient takes a zero one, so it still decays."""

    def __init__(self, params, schedule, weight_decay: float):
        super().__init__(params)
        self.schedule, self.weight_decay = schedule, weight_decay

    @torch.no_grad()
    def step(self) -> None:
        lr = self.schedule(self.count)
        for p, u in zip(self.params, self.updates()):
            p.add_(u + self.weight_decay * p, alpha=-lr)


def train_apr(apr, imgs: torch.Tensor, gt12: torch.Tensor, train_idx,
              steps: int, lr: float, gen: torch.Generator) -> None:
    """steps AdamW steps (in place) of apr_loss on APR_BATCH training
    views (all of them when fewer) drawn from gen without replacement,
    each with its brightness scale ~ U(JITTER) and noise ~ N(0, 1) from
    gen; the learning rate decays as cosine_decay_schedule(lr, steps,
    APR_ALPHA), the weights by APR_WEIGHT_DECAY."""
    dev = imgs.device
    tr = torch.as_tensor(np.asarray(train_idx), device=dev)
    opt = AdamW(apr.parameters(), cosine_decay_schedule(lr, steps, APR_ALPHA),
                APR_WEIGHT_DECAY)
    apr.requires_grad_(True)
    lo, hi = JITTER
    for step in range(steps):
        perm = torch.randperm(len(tr), generator=gen, device=gen.device)
        sel = tr[perm[:APR_BATCH].to(dev)]
        scale = torch.rand((len(sel), 1, 1, 1), generator=gen,
                           device=gen.device).to(dev) * (hi - lo) + lo
        noise = torch.randn((len(sel), *imgs.shape[1:]), generator=gen,
                            device=gen.device).to(dev)
        opt.zero_grad()
        loss = apr_loss(apr, imgs[sel], gt12[sel], scale, noise)
        loss.backward()
        opt.step()
        if step % 100 == 0:
            print(f"apr step {step} loss={loss.item():.5f}", flush=True)
    opt.zero_grad()
    apr.requires_grad_(False)


# --------------------------------------------------------------------------
# refinement and its summaries
# --------------------------------------------------------------------------

def run_refine(model, apr, images, targets, hists, ws_vec, hwf: tuple,
               full_hwf: tuple, near: float, far: float, cfg, gt, lr: float,
               iters: int, per_pixel: bool, fusion: str, chunk: int) -> dict:
    """Mode 2 (svd_reg) of every test frame at one (lr, iters, per_pixel,
    fusion), chunk frames a refine_apr_batch call, then the verification
    fail-safe; errors against gt (N, 3, 4). Returns the configuration, the
    batched result ("out", on the host), the verified, refined and initial
    poses, their errors and the verified medians."""
    rfc = RefineConfig(opt_iter=iters, learning_rate=lr, per_pixel=per_pixel,
                       fusion=fusion)
    chunks = []
    for s in range(0, images.shape[0], max(1, chunk)):
        o = refine_apr_batch(model, apr, images[s:s + chunk],
                             targets[s:s + chunk], hists[s:s + chunk], ws_vec,
                             hwf, full_hwf, near, far, cfg, rfc, svd_reg=True)
        chunks.append({k: v.detach().cpu() for k, v in o.items()})
    out = {k: torch.cat([c[k] for c in chunks]).numpy() for k in chunks[0]}
    verified = apply_verification(out).numpy()
    refined, init_poses = out["refined_pose"], out["initial_pose"]
    e_init, e_ver = pose_errors(init_poses, gt), pose_errors(verified, gt)
    return {"lr": lr, "iters": iters, "per_pixel": per_pixel,
            "fusion": fusion, "out": out, "verified": verified,
            "refined": refined, "init_poses": init_poses, "err_init": e_init,
            "err_ver": e_ver, "median_t": float(np.median(e_ver[:, 0])),
            "median_r": float(np.median(e_ver[:, 1]))}


def verification_confusion(err_init: np.ndarray, err_ref: np.ndarray,
                           retreated: np.ndarray) -> tuple:
    """A frame is degraded when its unverified refined translation error
    exceeds its initial one; against the fail-safe's retreats: (the
    confusion dict, the degraded mask)."""
    degraded = err_ref[:, 0] > err_init[:, 0] + 1e-9
    return {
        "degraded_frames": int(degraded.sum()),
        "retreat_true_positive": int(np.sum(degraded & retreated)),
        "retreat_miss": int(np.sum(degraded & ~retreated)),
        "retreat_false_positive": int(np.sum(~degraded & retreated)),
        "proxy_miss_rate": float(np.sum(degraded & ~retreated)
                                 / max(int(degraded.sum()), 1)),
    }, degraded


def proxy_comparison(losses: np.ndarray, retreated: np.ndarray,
                     degraded: np.ndarray, init_poses: np.ndarray,
                     refined: np.ndarray, gt: np.ndarray,
                     err_init: np.ndarray) -> dict:
    """Three retreat proxies on the same run: "psnr_ssim" (the fail-safe's
    own retreats), "dfm" (the last loss of losses (N, iters) above the
    first) and "either": each one's retreats against the degraded frames,
    the medians of the poses it keeps and its frames worse than their
    initial pose."""
    prox = {"psnr_ssim": retreated, "dfm": losses[:, -1] > losses[:, 0]}
    prox["either"] = prox["psnr_ssim"] | prox["dfm"]
    out = {}
    for name, ret in prox.items():
        e = pose_errors(np.where(ret[:, None, None], init_poses, refined), gt)
        out[name] = {
            "retreats": int(ret.sum()),
            "true_positive": int(np.sum(degraded & ret)),
            "miss": int(np.sum(degraded & ~ret)),
            "false_positive": int(np.sum(~degraded & ret)),
            "median_t_m": float(np.median(e[:, 0])),
            "median_r_deg": float(np.median(e[:, 1])),
            "frames_worse_than_init": int(np.sum(
                e[:, 0] > err_init[:, 0] + 1e-9)),
        }
    return out


def best_mode3(runs: list, t0: float, r0: float) -> dict:
    """The mode-3 run with the largest summed relative improvement of the
    median translation and rotation over (t0, r0)."""
    return max(runs, key=lambda r: (t0 - r["median_t_m"]) / t0
               + (r0 - r["median_r_deg"]) / r0)
