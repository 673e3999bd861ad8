"""Sharded training and rendering over a Mesh (parallel/mesh.py); port of
nefes_tpu/parallel/train_dp.py.

The JAX package replicates the parameters and lets XLA split the batch
and insert the gradient all-reduce. Here each rank holds the whole model
and renders its share, and the collectives are explicit:

  make_sharded_train_step  train_step_rays with the batch's images over
                           "data" and their rays over "rays"; the
                           gradients averaged over the ranks before the
                           optimizer step, so every rank's state stays one
  refine_poses_sharded /   the frame axis over every rank, each running
  refine_apr_sharded       refine_poses_batch / refine_apr_batch on its
                           frames, the results gathered in frame order
  render_rays_sharded      one image's rays over every rank

The sharded step equals train_step_rays on the whole batch: every rank
draws the whole batch's random tensors from its generator, in the order
the one-rank step draws them, and keeps its own rows (render/sampling.py
RowShard), so the generators stay in one state and the TV cube is drawn
alike on every rank. The loss is a mean over the batch's rays, so the
mean of the ranks' losses is the batch's, and the mean of their
gradients its gradient; a term every rank computes alike (the TV cube)
stays counted once. On one rank the collectives change nothing.
"""

from __future__ import annotations

import torch

from nefes_tpu_torch.parallel.mesh import (
    Mesh, _group_on, all_mean, frame_sharding, gather_frames, replicate,
)
from nefes_tpu_torch.render.renderer import RenderConfig, render_rays
from nefes_tpu_torch.render.sampling import RowShard
from nefes_tpu_torch.train.trainer import (
    AuxConfig, TrainState, _detached, rays_loss, top_pixels,
)


@torch.no_grad()
def _mean_gradients(mesh: Mesh, params: list) -> None:
    """Every parameter's gradient (zero where it has none, as the
    optimizer takes it) replaced by its mean over the ranks, in one
    all-reduce."""
    if not _group_on():
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_mean(mesh, torch.cat([g.reshape(-1) for g in grads]))
    for p, part in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = part.view_as(p)


def _mean_metrics(mesh: Mesh, loss: torch.Tensor, metrics: dict):
    """The loss and the metrics averaged over the ranks; psnr through its
    MSE (the batch's psnr is that of the mean squared error)."""
    if not _group_on():
        return loss, metrics
    names = list(metrics)
    vals = [metrics[k] for k in names]
    if mesh.size > 1 and "psnr" in metrics:
        vals[names.index("psnr")] = 10.0 ** (-metrics["psnr"] / 10.0)
    out = all_mean(mesh, torch.stack([loss, *vals]))
    means = dict(zip(names, out[1:]))
    if mesh.size > 1 and "psnr" in metrics:
        means["psnr"] = -10.0 * torch.log10(means["psnr"])
    return out[0], means


def make_sharded_train_step(cfg: RenderConfig, mesh: Mesh, hwf: tuple,
                            near: float, far: float, n_rand: int = 1536,
                            stage: int = 0, aux: AuxConfig = AuxConfig()):
    """train_step_rays over the mesh. Returns step(state, batch, gen, lr)
    -> (state, loss, metrics): batch is this rank's shard_batch of the
    whole batch, every rank's state and gen start alike (replicate the
    model; seed the generators alike), and the loss and metrics are the
    whole batch's. The state is updated in place, alike on every rank."""
    if n_rand % mesh.rays:
        raise ValueError(f"{n_rand} rays an image do not split over "
                         f"{mesh.rays} ranks")
    if aux.depth and mesh.size > 1:
        raise ValueError("the depth term normalises by its batch's median: "
                         "it does not split over ranks")
    H, W, _ = hwf
    n_local = n_rand // mesh.rays

    def step(state: TrainState, batch: dict, gen: torch.Generator,
             lr: float):
        poses = batch["poses"]
        bl = poses.shape[0]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones((bl, H, W), device=poses.device)
        d, r = mesh.data_index, mesh.rays_index
        # the whole batch's pixel keys, as train_step_rays draws them:
        # this rank's images' rows, and its rays of their choice
        keys = torch.rand((bl * mesh.data, H * W), generator=gen,
                          device=gen.device)[d * bl:(d + 1) * bl]
        idx = top_pixels(keys, mask, n_rand)[:, r * n_local:
                                             (r + 1) * n_local]
        # the render's rows of the whole batch's (B · n_rand) rays
        b = torch.arange(d * bl, (d + 1) * bl, device=gen.device)
        n = torch.arange(r * n_local, (r + 1) * n_local, device=gen.device)
        shard = RowShard(gen, (b[:, None] * n_rand + n).reshape(-1),
                         bl * mesh.data * n_rand)
        loss, metrics = rays_loss(state.model, cfg, batch, idx, shard, hwf,
                                  near, far, stage, aux)
        state.tx.zero_grad()
        loss.backward()
        _mean_gradients(mesh, state.tx.params)
        state.tx.step(lr)
        return (state, *_mean_metrics(mesh, *_detached(loss, metrics)))

    return step


def _frames(mesh: Mesh, x):
    return None if x is None else frame_sharding(mesh, x.to(mesh.device))


def refine_poses_sharded(model, init_poses, target_feats, hists, ws,
                         hwf: tuple, cfg: RenderConfig, rcfg, mesh: Mesh,
                         masks=None):
    """Mode 3 of a whole test set across the mesh: the frames (every rank
    passes all of them) split over every rank, each rank refining its own
    with refine_poses_batch and rank 0's field. The frame count must
    divide the ranks (pad with repeats and drop the extras).

    Returns (refined poses (N, 3, 4), losses (N, opt_iter)) on every
    rank."""
    from nefes_tpu_torch.refine.pose_opt import refine_poses_batch

    replicate(mesh, model)
    refined, losses = refine_poses_batch(
        model, _frames(mesh, init_poses), _frames(mesh, target_feats),
        _frames(mesh, hists), ws, hwf, cfg, rcfg, masks=_frames(mesh, masks))
    return gather_frames(mesh, refined), gather_frames(mesh, losses)


def refine_apr_sharded(model, dfnet, images, targets, hists, ws_vec,
                       hwf_render: tuple, hwf_full: tuple, near: float,
                       far: float, cfg: RenderConfig, rcfg, mesh: Mesh,
                       svd_reg: bool = True, masks=None,
                       freeze_bn: bool = True, apr_kind: str = "DFNet",
                       dataset_type: str = "7Scenes",
                       pose_avg=None) -> dict:
    """Mode 2 of a frame batch across the mesh: the frames (images,
    targets, hists, masks; every rank passes all of them) split over
    every rank, each running refine_apr_batch on its own with rank 0's
    field and APR. The frame count must divide the ranks.

    Returns refine_apr_batch's dict of the whole batch on every rank."""
    from nefes_tpu_torch.refine.apr_opt import refine_apr_batch

    replicate(mesh, model)
    replicate(mesh, dfnet)
    out = refine_apr_batch(
        model, dfnet, _frames(mesh, images), _frames(mesh, targets),
        _frames(mesh, hists), ws_vec.to(mesh.device), hwf_render, hwf_full,
        near, far, cfg, rcfg, svd_reg=svd_reg, masks=_frames(mesh, masks),
        freeze_bn=freeze_bn, apr_kind=apr_kind, dataset_type=dataset_type,
        pose_avg=pose_avg)
    return {k: gather_frames(mesh, v) for k, v in out.items()}


@torch.no_grad()
def render_rays_sharded(model, rays_o, rays_d, near, far,
                        cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """One image's flattened rays (R, 3) split over every rank, rendered
    through render_rays with rank 0's field (the coarse and fine fields
    of the one model, under cfg's kernels); returns the rgb (R, 3) on
    every rank. R must divide the ranks (pad, and drop the extras)."""
    replicate(mesh, model)
    fns = model.field_fns(cfg)
    rgb = render_rays(*fns, _frames(mesh, rays_o), _frames(mesh, rays_d),
                      near, far, None, cfg)["rgb"]
    return gather_frames(mesh, rgb)
