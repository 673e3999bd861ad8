"""NeFeS field training: the random-ray step of stages 0/1, the stage-2
patch step through FusionNet, the schedule and the optimizer; port of
nefes_tpu/train/trainer.py (reference script/run_nefes.py).

  train_step_rays   stages 0/1: B x N_rand random rays per step
                    (run_nefes.py:42-76, 210-256)
  train_step_patch  stage 2: NUM_CROPS random CROP_SIZE^2 patches, the
                    same for every image, rendered and fused by FusionNet
                    (run_nefes.py:78-108, 150-243)

Both take the learning rate per step (the reference decays it every step,
run_nefes.py:265-271). Each step's loss is a module-level function
(rays_loss, patch_loss) of the selected pixels or the crop corners. The
steps update the state in place: the model's parameters and FusionNet's
running statistics, and the optimizer's moments.

With cfg.fused the fields run through the kernels (kernels/), packed
anew every step so that the kernels' weight gradients reach the
parameters: the raw-input kernels K5/K6 (cfg.fused_pre False) or the
pre-embedded K1/K2, the fine pass in transient mode when the transient
heads are on. Training needs cfg.fused_need_dw and cannot take
cfg.fused_render (the frozen-field refinement render).

A zoo field (train/field_zoo.py) trains through the same steps on the
plain fields, each ray of the batch's one field pass conditioned on its
image's latents; it has no feature head and no FusionNet, so its patch
step is the colour loss on the patches' pixels, and the l1normloss term
regularises its hash tables.

Both steps take the Nerfies window of reduce_embedding=2 (embedded here,
so through the plain fields or K1/K2; the raw-input kernels refuse it),
and the random-ray step the auxiliary terms of AuxConfig: TV on density,
Cauchy and mean sigma sparsity, the DPT depth term.

Stage semantics (run_nefes.py:34-40): schedule 1 runs stage 0 (colour
only) for every epoch; schedule 2 runs stage 1 (colour + features) until
EPOCH_TO_FUSION, then stage 2 (+ fusion, patch sampling).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nefes_tpu_torch.fields.embedder import embed
from nefes_tpu_torch.geometry.rays import get_ray_at
from nefes_tpu_torch.render.renderer import RenderConfig, render_rays
from nefes_tpu_torch.train.field_zoo import ZooFieldModel
from nefes_tpu_torch.train.aux_losses import (
    compute_depth_loss, embeddings_l1_loss, sigma_sparsity_loss,
    sigma_sparsity_loss2, total_variation_loss,
)
from nefes_tpu_torch.train.losses import nefes_training_loss, psnr
from nefes_tpu_torch.train.model import NeFeSModel

EPOCH_TO_FUSION = 200   # run_nefes.py:37
NUM_CROPS = 7           # run_nefes.py:87
CROP_SIZE = 16          # run_nefes.py:88


@dataclass(frozen=True)
class AuxConfig:
    """Auxiliary regularizer switches (reference options.py:52-55, 78-79;
    the math in train/aux_losses.py)."""

    tvloss: bool = False
    tvloss_w: float = 1e-6
    l1normloss: bool = False        # hash-grid tables only
    l1normloss_w: float = 1e-6
    sigma_sparsity: bool = False
    sigma_sparsity2: bool = False
    bound: float = 4.0              # world box half-side of the TV cube
    # DPT mono-depth supervision (reference --depth, options.py:61; the
    # loss is losses.py:175-191, whose call site is dead code in the
    # reference scripts, so the 0.1 weight is the JAX package's choice)
    depth: bool = False
    depth_w: float = 0.1

    @classmethod
    def from_options(cls, opts, far: float) -> "AuxConfig":
        return cls(tvloss=opts.tvloss, tvloss_w=opts.tvloss_w,
                   l1normloss=opts.l1normloss,
                   l1normloss_w=opts.l1normloss_w,
                   sigma_sparsity=opts.sigma_sparsity_loss,
                   sigma_sparsity2=opts.sigma_sparsity_loss2,
                   depth=opts.depth_loss, bound=float(far))

    @property
    def any_on(self) -> bool:
        return (self.tvloss or self.l1normloss or self.sigma_sparsity
                or self.sigma_sparsity2)


# the TV cube of the training step: 6³ points at a 64³ grid of the box
TV_RESOLUTION = (64, 64, 64)


def aux_regularizers(aux: AuxConfig, model: NeFeSModel, out: dict,
                     cfg: RenderConfig, gen: torch.Generator | None = None,
                     tv_corners=None) -> torch.Tensor:
    """Sum of the enabled aux terms. TV samples the plain coarse and fine
    densities over a sub-cube of [-bound, bound]³ (the reference's
    normalised hash domain, losses.py:226-265) with corners tv_corners,
    drawn from gen when None; sparsity acts on the batch's raw fine
    sigmas (out["static_sigmas"], the kernels' too)."""
    loss = torch.zeros((), device=out["rgb"].device)
    if aux.l1normloss:
        # the hash-grid tables' L1 (reference embeddings_L1_loss,
        # losses.py:284-314); encoder_fns raises for any other field (the
        # CLI drops the flag for them)
        if not isinstance(model, ZooFieldModel):
            raise ValueError("l1normloss regularises hash-grid tables; the "
                             "NeRFH-NFF field has none (the CLI drops the "
                             "flag for it)")
        loss = loss + aux.l1normloss_w * embeddings_l1_loss(
            *model.encoder_fns())
    if aux.tvloss:
        dev = next(model.parameters()).device

        def density(fn):
            def sigma(x01):
                xyz = ((x01 * 2.0 - 1.0) * aux.bound).to(dev)
                return fn(embed(xyz, cfg.xyz_embed), None, True,
                          False)["static_sigma"]
            return sigma
        loss = loss + aux.tvloss_w * total_variation_loss(
            density(model.coarse_fn), density(model.fine_fn), tv_corners,
            gen, sample_resolution=TV_RESOLUTION)
    if aux.sigma_sparsity:
        loss = loss + torch.mean(sigma_sparsity_loss(out["static_sigmas"]))
    if aux.sigma_sparsity2:
        loss = loss + sigma_sparsity_loss2(out["static_sigmas"])
    return loss


def stage_for_epoch(new_schedule: int, epoch: int) -> int:
    if new_schedule != 2:
        return 0
    return 1 if epoch < EPOCH_TO_FUSION else 2


def lr_for_epoch(epoch: int, lrate: float = 5e-4,
                 lrate_decay: float = 0.754) -> float:
    """lrate · 0.1^(epoch / (lrate_decay·1000)), run_nefes.py:265-271."""
    return lrate * (0.1 ** (epoch / (lrate_decay * 1000.0)))


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: every gradient times max_norm / norm
    when the global L2 norm reaches max_norm, else unchanged (no epsilon,
    unlike torch.nn.utils.clip_grad_norm_)."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    if norm < max_norm:
        return grads
    return [(g / norm) * max_norm for g in grads]


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) with the
    learning rate given at each step (optax.inject_hyperparams) and, when
    grad_clip > 0, clip_by_global_norm first (the JAX make_optimizer). As
    optax: one step count for all parameters, and a parameter without a
    gradient takes a zero one (its moments decay; it moves by what they
    still hold). Updates the parameters in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, grad_clip: float = 0.0):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def updates(self) -> list:
        """Advance the moments by the parameters' gradients; returns each
        parameter's bias-corrected Adam direction (before the learning
        rate)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        out = []
        for g, m, v in zip(grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            out.append((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
        return out

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for p, u in zip(self.params, self.updates()):
            p.add_(u, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu), "grad_clip": self.grad_clip}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.grad_clip = float(state["grad_clip"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)


def make_optimizer(params, grad_clip: float = 0.0) -> Adam:
    """Adam(0.9, 0.999) over `params` (nerfh_nff.py:682); grad_clip > 0
    prepends global-norm clipping (off by default, as in the reference;
    the JAX package's docstring says why it exists)."""
    return Adam(params, grad_clip)


@dataclass
class TrainState:
    """The model (parameters and FusionNet's running statistics), the
    optimizer and the epoch: what a checkpoint holds."""

    model: NeFeSModel
    tx: Adam
    epoch: int = 0


def create_train_state(model: NeFeSModel, tx: Adam | None = None
                       ) -> TrainState:
    return TrainState(model=model,
                      tx=tx or make_optimizer(model.parameters()))


def _select_ray_pixels(gen: torch.Generator, n_rand: int, H: int, W: int,
                       mask: torch.Tensor) -> torch.Tensor:
    """n_rand pixel indices per image, (B, n_rand) into H·W on mask's
    device: uniform without replacement among the pixels with mask > 0
    (mask (B, H, W)), as the top n_rand of uniform keys (the JAX package's
    Gumbel top-k); masked pixels only when fewer than n_rand are valid."""
    keys = torch.rand((mask.shape[0], H * W), generator=gen,
                      device=gen.device)
    return top_pixels(keys, mask, n_rand)


def top_pixels(keys: torch.Tensor, mask: torch.Tensor,
               n_rand: int) -> torch.Tensor:
    """_select_ray_pixels' choice from its keys (B, H·W)."""
    B = mask.shape[0]
    keys = keys.to(mask.device).masked_fill(mask.reshape(B, -1) <= 0, -1.0)
    return keys.topk(n_rand, dim=1).indices


def _gather(imgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """imgs (B, H, W[, C]) at flat pixel indices idx (B, N) or (N,)."""
    B = imgs.shape[0]
    flat = imgs.reshape(B, -1, imgs.shape[3] if imgs.dim() == 4 else 1)
    idx = idx.expand(B, -1) if idx.dim() == 1 else idx
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                       flat.shape[2]))


def _field_fns(model: NeFeSModel, cfg: RenderConfig, hists, n_rays: int):
    """The step's field fns: the plain fields, each of the batch's n_rays
    rays an image conditioned on its image's histogram hists (B, bins)
    (the zoo's latents; NeRFH-NFF's fields take none), or, with
    cfg.fused, the field kernels on weights packed now, with their weight
    gradients."""
    if not cfg.fused:
        return model.ray_field_fns(hists, n_rays)
    if cfg.fused_render:
        raise ValueError("fused_render is the frozen-field refinement "
                         "render; training runs the field kernels "
                         "(fused_render=False)")
    if not cfg.fused_need_dw:
        raise ValueError("training through the kernels needs "
                         "fused_need_dw=True: without it the fields get no "
                         "weight gradients")
    return model.field_fns(cfg)


def _render_selected(model: NeFeSModel, cfg: RenderConfig, poses, hists,
                     px, py, H, W, focal, near, far, gen,
                     window=None) -> dict:
    """Render the rays at per-image pixel coordinates px, py (B, N) under
    poses (B, 3, 4), all B·N rays in one render_rays (so one launch per
    field pass; a zoo field's rays each with its image's latents, from
    hists (B, bins)). Returns the train render dict with (B, N, ...)
    leaves."""
    B, N = px.shape
    coarse_fn, fine_fn = _field_fns(model, cfg, hists, N)
    ro, rd = get_ray_at(px, py, focal, H, W, poses)
    out = render_rays(coarse_fn, fine_fn, ro.reshape(-1, 3),
                      rd.reshape(-1, 3), near, far, gen, cfg, window=window)
    return {k: (None if v is None else v.reshape(B, N, *v.shape[1:]))
            for k, v in out.items()}


def _finalize_rgb(model: NeFeSModel, out: dict, hists) -> dict:
    """Exposure-correct the fine rgb (run_nefes.py:153-155, 215-217)."""
    out = dict(out)
    out["rgb"] = model.apply_exposure(hists, out["rgb"])
    return out


def rays_loss(model: NeFeSModel, cfg: RenderConfig, batch: dict,
              idx: torch.Tensor, gen, hwf: tuple, near: float, far: float,
              stage: int = 0, aux: AuxConfig = AuxConfig(), window=None,
              tv_corners=None):
    """The random-ray step's loss at the selected pixels idx (B, N) (flat
    indices into H·W): (loss, metrics). aux's terms are added (the TV
    cube at tv_corners, drawn from gen when None; the depth term against
    batch["depth"] (B, H, W) where aux.depth and the batch has it);
    window is the Nerfies pair or None."""
    H, W, focal = hwf
    px, py = (idx % W).float(), torch.div(idx, W,
                                          rounding_mode="floor").float()
    target_rgb = _gather(batch["rgb"], idx)
    target_feat = _gather(batch["feat"], idx) if stage >= 1 else None
    target_depth = (_gather(batch["depth"], idx)[..., 0]
                    if aux.depth and "depth" in batch else None)
    out = _render_selected(model, cfg, batch["poses"], batch["hists"], px,
                           py, H, W, focal, near, far, gen, window)
    out = _finalize_rgb(model, out, batch["hists"])
    loss, metrics = nefes_training_loss(out, target_rgb, target_feat,
                                        fusion_out=None, stage=min(stage, 1))
    if aux.any_on:
        loss = loss + aux_regularizers(aux, model, out, cfg, gen,
                                       tv_corners)
    if target_depth is not None:
        loss_d = compute_depth_loss(out["depth"], target_depth)
        loss = loss + aux.depth_w * loss_d
        metrics["loss_depth"] = loss_d
    metrics["psnr"] = psnr(out["rgb"], target_rgb)
    return loss, metrics


def patch_loss(model: NeFeSModel, cfg: RenderConfig, batch: dict,
               h0: torch.Tensor, w0: torch.Tensor, gen, hwf: tuple,
               near: float, far: float, window=None):
    """The stage-2 step's loss on the NUM_CROPS patches with top-left
    corners (h0, w0) (NUM_CROPS,), the same in every image: (loss,
    metrics, FusionNet's new running statistics | None). window is the
    Nerfies pair or None."""
    H, W, focal = hwf
    B = batch["poses"].shape[0]
    ar = torch.arange(CROP_SIZE, device=h0.device)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    py = (h0[:, None, None] + dy).reshape(-1)        # (NUM_CROPS·16·16,)
    px = (w0[:, None, None] + dx).reshape(-1)
    idx = py * W + px
    target_rgb = _gather(batch["rgb"], idx)
    target_feat = (None if isinstance(model, ZooFieldModel)
                   else _gather(batch["feat"], idx))
    # contiguous patches cannot avoid masked-out pixels at selection:
    # they leave the feature and fusion terms instead
    mask = batch.get("mask")
    patch_mask = _gather(mask, idx)[..., 0] if mask is not None else None
    out = _render_selected(model, cfg, batch["poses"], batch["hists"],
                           px.float().expand(B, -1), py.float().expand(B, -1),
                           H, W, focal, near, far, gen, window)
    out = _finalize_rgb(model, out, batch["hists"])
    if isinstance(model, ZooFieldModel):
        # a zoo field has no feature head and no FusionNet: the colour
        # loss on the patches' pixels
        loss, metrics = nefes_training_loss(out, target_rgb, None,
                                            fusion_out=None, stage=0)
        metrics["psnr"] = psnr(out["rgb"], target_rgb)
        return loss, metrics, None

    def as_img(x):
        return x.reshape(B * NUM_CROPS, CROP_SIZE, CROP_SIZE, x.shape[-1])

    fusion_out, new_stats = model.apply_fusion(as_img(out["rgb"]),
                                               as_img(out["feat"]),
                                               train=True)
    fusion_flat = fusion_out.reshape(B, NUM_CROPS * CROP_SIZE ** 2, -1)
    loss, metrics = nefes_training_loss(out, target_rgb, target_feat,
                                        fusion_out=fusion_flat, stage=2,
                                        mask=patch_mask)
    metrics["psnr"] = psnr(out["rgb"], target_rgb)
    return loss, metrics, new_stats


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    lr: float) -> None:
    """Backprop `loss` into the parameters and take one optimizer step."""
    state.tx.zero_grad()
    loss.backward()
    state.tx.step(lr)


def _detached(loss, metrics):
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def train_step_rays(state: TrainState, cfg: RenderConfig, batch: dict,
                    gen: torch.Generator, lr: float, hwf: tuple,
                    near: float, far: float, n_rand: int = 1536,
                    stage: int = 0, aux: AuxConfig = AuxConfig(),
                    window=None):
    """One random-ray step. batch: rgb (B, H, W, 3) at render scale,
    poses (B, 3, 4), hists (B, bins), feat (B, H, W, F) from stage 1,
    mask (B, H, W) optional, depth (B, H, W) for aux.depth. `gen` draws
    the pixels, the renderer's noise and the TV cube. window: the
    Nerfies pair (xyz_window, dir_window) of reduce_embedding=2 or None.
    Returns (state, loss, metrics); the state is updated in place."""
    H, W, _ = hwf
    poses = batch["poses"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((poses.shape[0], H, W), device=poses.device)
    idx = _select_ray_pixels(gen, n_rand, H, W, mask)
    loss, metrics = rays_loss(state.model, cfg, batch, idx, gen, hwf, near,
                              far, stage, aux, window)
    apply_gradients(state, loss, lr)
    return (state, *_detached(loss, metrics))


def train_step_patch(state: TrainState, cfg: RenderConfig, batch: dict,
                     gen: torch.Generator, lr: float, hwf: tuple,
                     near: float, far: float, window=None):
    """One stage-2 step: NUM_CROPS random CROP_SIZE² patches (the same
    corners for every image, run_nefes.py:85-94), rendered and fused.
    FusionNet's running statistics take the batch's (flax momentum 0.9).
    Returns (state, loss, metrics); the state is updated in place."""
    H, W, _ = hwf
    dev = batch["poses"].device
    # jax.random.randint gives minval where maxval <= minval: an image
    # one patch wide takes corner 0
    corners = [torch.randint(0, max(n - CROP_SIZE, 1), (NUM_CROPS,),
                             generator=gen, device=gen.device).to(dev)
               for n in (H, W)]
    loss, metrics, new_stats = patch_loss(state.model, cfg, batch, *corners,
                                          gen, hwf, near, far, window)
    apply_gradients(state, loss, lr)
    if new_stats is not None:
        bn = state.model.fusion.bn
        bn.running_mean.copy_(new_stats["running_mean"])
        bn.running_var.copy_(new_stats["running_var"])
    return (state, *_detached(loss, metrics))
