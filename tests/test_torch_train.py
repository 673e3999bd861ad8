"""The port's field training (nefes_tpu_torch/train/) against the JAX
package's, on the CPU in f32 at a tiny model size, where the kernel
wrappers run their plain versions.

1. One random-ray step (train_step_rays' rays_loss and update) at given
   pixels, stages 0 and 1, NeRF-W transient heads on, perturb off, on two
   routes: the plain fields, against JAX value_and_grad of
   _render_selected -> _finalize_rgb -> nefes_training_loss; and the
   field kernels with weight gradients (fused=True, fused_need_dw=True,
   raw inputs: K5/K6), against the same JAX loss rendered through
   coarse_raw_fn / fine_raw_fn(need_dw=True, interpret=True) on
   pack_fused(params). Loss to 1e-5 relative, every parameter's gradient
   to 2e-4 of its largest entry (the kernel tests' tolerance), the
   parameters after one Adam step to 1e-3 of the learning rate (Adam's
   first step moves a weight by lr · g / (|g| + 1e-8), so a gradient
   within rounding of 1e-8 may move by another fraction of lr).
2. One stage-2 patch step at given crop corners (patch_loss and the
   update): loss, gradients (FusionNet's included), parameters after the
   step, and FusionNet's new BN running mean and variance (flax
   momentum 0.9, biased variance) to 1e-5 relative.
3. The small pieces: pixel selection under a mask, the schedule, the
   optax-style global-norm clip, a checkpoint round trip, the refused
   options (a window on the raw-input kernels, kernels without weight
   gradients, the refinement's fused render), the synthetic scene and
   histograms against the JAX package.
4. End to end: the stage-0 loss falls over 30 steps on the port's
   synthetic scene, and stage-1 steps take its rendered features, as
   tests/test_training_e2e.py shows for the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefes_tpu.data.histograms import luminance_histogram as jhist
from nefes_tpu.data.synthetic import blob_field as jblob
from nefes_tpu.data.synthetic import look_at_pose as jlook_at
from nefes_tpu.geometry.rays import get_ray_at as jget_ray_at
from nefes_tpu.render.renderer import render_rays as jrender_rays
from nefes_tpu.train import losses as jlosses
from nefes_tpu.train import trainer as jtrainer
from nefes_tpu_torch.data.histograms import luminance_histogram
from nefes_tpu_torch.data.synthetic import (
    blob_field, look_at_pose, make_synthetic_scene, render_gt_features,
)
from nefes_tpu_torch.fields.embedder import train_windows
from nefes_tpu_torch.train import (
    create_train_state, latest_checkpoint, lr_for_epoch,
    patch_loss, rays_loss, restore_checkpoint, save_checkpoint,
    stage_for_epoch, train_step_patch, train_step_rays,
)
from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
from nefes_tpu_torch.train.trainer import (
    _select_ray_pixels, apply_gradients, clip_by_global_norm,
)
from tests.torch_parity import close, configs, grads_by_name, models, n
from tests.torch_parity import replace, t

RNG = np.random.default_rng(3)
H, W, FOCAL, NEAR, FAR = 20, 24, 18.0, 0.5, 4.0
B, N_PIX, LR = 2, 12, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Training steps at this size are thousands of tiny ops: with every
    test worker's torch using all cores they slow down many times over;
    one thread each runs them at full speed. Restored afterwards."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-6)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    eyes = [(2.0 * np.sin(a), 0.3, 2.0 * np.cos(a)) for a in (0.0, 0.7)]
    poses = np.stack([look_at_pose(np.array(e, np.float32)) for e in eyes])
    batch = {"rgb": RNG.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "feat": RNG.normal(0, 1, (B, H, W, 8)).astype(np.float32),
             "poses": poses,
             "hists": RNG.uniform(0, 30, (B, 10)).round().astype(np.float32),
             "mask": (RNG.uniform(0, 1, (B, H, W)) > 0.2).astype(np.float32)}
    kw = dict(n_samples=8, n_importance=8, perturb=False,
              output_transient=True)
    return jcfg, tcfg, jcfg.render_config(**kw), tcfg.render_config(**kw), \
        batch


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _jax_update(params, grads, lr):
    tx = jtrainer.make_optimizer()
    opt = tx.init(params)
    opt.hyperparams["learning_rate"] = jnp.asarray(lr)
    updates, _ = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates)


def _pixels(mask):
    """N_PIX distinct pixels per image among the mask's."""
    idx = [RNG.choice(np.flatnonzero(m.reshape(-1) > 0), N_PIX,
                      replace=False) for m in mask]
    return np.stack(idx).astype(np.int64)


@pytest.fixture(scope="module")
def ref(setup):
    """The JAX side of every step test, in one jitted program: for each
    route (unfused, kernels) and stage (0, 1) the random-ray step's loss,
    gradients and parameters after one Adam step at the pixels idx; the
    patch step's at the corners (h0, w0), with its new BN statistics."""
    jcfg, tcfg, jrc, _, batch = setup
    jmodel, variables, _ = models(jcfg, tcfg)
    idx = _pixels(batch["mask"])
    C = jtrainer.CROP_SIZE
    h0 = RNG.integers(0, H - C, jtrainer.NUM_CROPS)
    w0 = RNG.integers(0, W - C, jtrainer.NUM_CROPS)
    hists, poses = jnp.asarray(batch["hists"]), jnp.asarray(batch["poses"])
    flags = dict(fused=True, fused_pre=False, fused_need_dw=True)

    def take(a, i):
        return jnp.asarray(np.take_along_axis(
            a.reshape(B, H * W, -1), np.broadcast_to(i, (B, i.shape[-1]))
            [..., None], axis=1))

    def render(params, px, py, fused):
        n_pix = px.shape[1]
        if not fused:
            return jtrainer._render_selected(
                jmodel, params, poses, px, py, hists, H, W, FOCAL, NEAR,
                FAR, jax.random.key(0), jrc)
        # the kernel route: every ray in one render_rays, as the port does
        pc, pf = jmodel.pack_fused(params)
        ro, rd = jax.vmap(lambda p, x, y: jget_ray_at(x, y, FOCAL, H, W, p))(
            poses, px, py)
        out = jrender_rays(jmodel.coarse_raw_fn(True, True),
                           jmodel.fine_raw_fn(True, True), pc, pf,
                           ro.reshape(-1, 3), rd.reshape(-1, 3), NEAR, FAR,
                           None, replace(jrc, **flags))
        return {k: v.reshape(B, n_pix, *v.shape[1:]) for k, v in out.items()
                if v is not None}

    def rays(params, fused, stage):
        px = jnp.asarray((idx % W).astype(np.float32))
        py = jnp.asarray((idx // W).astype(np.float32))
        out = jtrainer._finalize_rgb(jmodel, params,
                                     render(params, px, py, fused), hists)
        return jlosses.nefes_training_loss(
            out, take(batch["rgb"], idx),
            take(batch["feat"], idx) if stage else None, fusion_out=None,
            stage=stage)[0]

    dy, dx = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
    py_p = (h0[:, None, None] + dy).reshape(-1)
    px_p = (w0[:, None, None] + dx).reshape(-1)
    idx_p = py_p * W + px_p

    def patch(v):
        # the body of train_step_patch at given corners
        params = v["params"]
        full = lambda a: jnp.broadcast_to(  # noqa: E731
            jnp.asarray(a, jnp.float32), (B, idx_p.size))
        out = jtrainer._finalize_rgb(
            jmodel, params, render(params, full(px_p), full(py_p), False),
            hists)
        as_img = lambda x: x.reshape(B * jtrainer.NUM_CROPS, C, C,  # noqa
                                     x.shape[-1])
        fo, new_bs = jmodel.apply_fusion(v, as_img(out["rgb"]),
                                         as_img(out["feat"]), train=True)
        loss, _ = jlosses.nefes_training_loss(
            out, take(batch["rgb"], idx_p), take(batch["feat"], idx_p),
            fo.reshape(B, idx_p.size, -1), 2,
            mask=take(batch["mask"], idx_p)[..., 0])
        return loss, new_bs

    def run(v):
        params, res = v["params"], {}
        for fused in (False, True):
            for stage in (0, 1):
                loss, g = jax.value_and_grad(rays)(params, fused, stage)
                res[f"rays-{int(fused)}-{stage}"] = (
                    loss, g, _jax_update(params, g, LR))
        (loss, bs), g = jax.value_and_grad(patch, has_aux=True)(v)
        res["patch"] = (loss, g["params"],
                        _jax_update(params, g["params"], LR), bs)
        return res

    res = jax.jit(run, static_argnums=())(variables)
    return variables, idx, (h0, w0), jax.tree.map(np.asarray, res)


def _fresh_tmodel(tcfg, variables):
    from nefes_tpu_torch.weights import from_jax_variables
    m = NeFeSModel(tcfg, device="cpu")
    m.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables), tcfg))
    return m


def _compare_step(tmodel, before, variables, jgrads, jnew, tcfg, what):
    """Every parameter's gradient and its value after one Adam step. The
    step moves a weight by lr·g / (|g| + 1e-8), which is ill-conditioned
    where |g| is within a few orders of 1e-8: there the gradients' own
    tolerance says all, and the step is held to optax's formula on the
    port's gradient instead."""
    want_g = grads_by_name(jgrads, variables, tcfg)
    want_p = grads_by_name(jnew, variables, tcfg)
    for name, prm in tmodel.named_parameters():
        if name == "fusion.conv3.bias":
            # exactly 0 in exact arithmetic (FusionNet's batch-statistics
            # BN subtracts each channel's mean right after conv3); both
            # frameworks give rounding noise there, amplified by the
            # 1/var^1.5 of the BN backward, so Adam moves it by ±lr at
            # random
            continue
        g = n(prm.grad) if prm.grad is not None else np.zeros(prm.shape)
        _scaled_close(g, want_g[name], 2e-4, f"{what} grad {name}")
        step = (n(prm) - n(before[name])) / LR          # in units of lr
        want = (want_p[name] - n(before[name])) / LR
        well = np.abs(want_g[name]) >= 1e-5
        np.testing.assert_allclose(step[well], want[well], rtol=1e-3,
                                   atol=1e-3, err_msg=f"{what} step {name}")
        np.testing.assert_allclose(step, -g / (np.abs(g) + 1e-8), rtol=1e-4,
                                   atol=5e-5, err_msg=f"{what} adam {name}")


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "kernels"])
def test_rays_step_matches_jax(setup, ref, fused, stage):
    _, tcfg, _, trc, batch = setup
    variables, idx, _, res = ref
    jl, jg, jnew = res[f"rays-{int(fused)}-{stage}"]
    tmodel = _fresh_tmodel(tcfg, variables)
    cfg = (replace(trc, fused=True, fused_pre=False, fused_need_dw=True)
           if fused else trc)
    st = create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    loss, metrics = rays_loss(tmodel, cfg, _torch_batch(batch),
                              torch.from_numpy(idx), None, (H, W, FOCAL),
                              NEAR, FAR, stage)
    assert ("loss_feat" in metrics) == (stage == 1)
    close(loss, jl, 1e-5, 1e-6, "loss")
    apply_gradients(st, loss, LR)
    _compare_step(tmodel, before, variables, jg, jnew, tcfg,
                  "kernels" if fused else "unfused")


def test_patch_step_matches_jax(setup, ref):
    _, tcfg, _, trc, batch = setup
    variables, _, (h0, w0), res = ref
    jl, jg, jnew, new_bs = res["patch"]
    tmodel = _fresh_tmodel(tcfg, variables)
    st = create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    loss, metrics, new_stats = patch_loss(
        tmodel, trc, _torch_batch(batch), torch.from_numpy(h0),
        torch.from_numpy(w0), None, (H, W, FOCAL), NEAR, FAR)
    assert {"loss_rgb", "loss_feat", "loss_fusion", "psnr"} <= set(metrics)
    close(loss, jl, 1e-5, 1e-6, "loss")
    apply_gradients(st, loss, LR)
    _compare_step(tmodel, before, variables, jg, jnew, tcfg, "patch")
    close(new_stats["running_mean"], new_bs["bn"]["mean"], 1e-5, 1e-6,
          "running mean")
    close(new_stats["running_var"], new_bs["bn"]["var"], 1e-5, 1e-6,
          "running var")


def test_train_steps_apply_bn_stats_and_refuse_unported(setup):
    """train_step_patch applies the new running statistics; a Nerfies
    window on the raw-input kernels (which embed inside and cannot apply
    it) and the options that would drop the fields' weight gradients
    raise."""
    _, tcfg, _, trc, batch = setup
    tmodel = NeFeSModel(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    st = create_train_state(tmodel)
    tb, gen = _torch_batch(batch), torch.Generator().manual_seed(0)
    mean0 = tmodel.fusion.bn.running_mean.clone()
    _, loss, _ = train_step_patch(st, trc, tb, gen, LR, (H, W, FOCAL), NEAR,
                                  FAR)
    assert torch.isfinite(loss)
    assert not torch.equal(tmodel.fusion.bn.running_mean, mean0)
    args = (st, trc, tb, gen, LR, (H, W, FOCAL), NEAR, FAR)
    window = train_windows(1.0, tcfg.xyz_embed, tcfg.dir_embed, 2.0)
    raw = replace(trc, fused=True, fused_pre=False, fused_need_dw=True)
    with pytest.raises(ValueError, match="window"):
        train_step_rays(st, raw, *args[2:], n_rand=8, window=window)
    for bad in (dict(fused=True, fused_need_dw=False),
                dict(fused=True, fused_render=True)):
        with pytest.raises(ValueError):
            train_step_rays(st, replace(trc, **bad), *args[2:], n_rand=8)


def test_select_ray_pixels_masked_without_replacement():
    mask = torch.from_numpy(RNG.uniform(0, 1, (3, 9, 11)) > 0.4).float()
    gen = torch.Generator().manual_seed(1)
    idx = _select_ray_pixels(gen, 20, 9, 11, mask)
    assert idx.shape == (3, 20)
    for m, i in zip(mask.reshape(3, -1), idx):
        assert len(set(i.tolist())) == 20
        assert (m[i] > 0).all()
    # every valid pixel when n_rand is their count
    full = torch.ones((1, 4, 5))
    full[0, 1, 2] = 0
    got = _select_ray_pixels(gen, 19, 4, 5, full)[0]
    assert sorted(got.tolist()) == [i for i in range(20) if i != 7]


def test_schedule_matches_jax():
    for epoch in (0, 1, 199, 200, 350, 1000):
        assert lr_for_epoch(epoch) == pytest.approx(
            jtrainer.lr_for_epoch(epoch), rel=1e-12)
        assert lr_for_epoch(epoch, 5e-3, 0.5) == pytest.approx(
            jtrainer.lr_for_epoch(epoch, 5e-3, 0.5), rel=1e-12)
        for sched in (1, 2):
            assert stage_for_epoch(sched, epoch) == jtrainer.stage_for_epoch(
                sched, epoch)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "not"])
def test_clip_matches_optax(max_norm):
    grads = [RNG.normal(0, 0.3, s).astype(np.float32)
             for s in ((5, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = clip_by_global_norm([t(g) for g in grads], max_norm)
    for a, b in zip(got, want):
        close(a, b, 1e-6, 1e-7)


def test_checkpoint_round_trip(setup, tmp_path):
    """A restored state takes the same next step as the one saved."""
    _, tcfg, _, trc, batch = setup
    tb = _torch_batch(batch)
    hwf = (H, W, FOCAL)

    def state(seed):
        return create_train_state(NeFeSModel(
            tcfg, device="cpu", generator=torch.Generator().manual_seed(seed)))

    a = state(0)
    train_step_rays(a, trc, tb, torch.Generator().manual_seed(1), LR, hwf,
                    NEAR, FAR, n_rand=16)
    a.epoch = 7
    path = save_checkpoint(tmp_path, a, 7)
    assert latest_checkpoint(tmp_path) == path
    b = restore_checkpoint(path, state(5))
    assert b.epoch == 7 and b.tx.count == a.tx.count == 1
    for s in (a, b):
        train_step_rays(s, trc, tb, torch.Generator().manual_seed(2), LR,
                        hwf, NEAR, FAR, n_rand=16, stage=1)
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k


def test_synthetic_field_and_histograms_match_jax():
    """blob_field (textured and plain) and the luminance histogram against
    the JAX package's; the scene's images are the port's renderer (held
    to the JAX one elsewhere) over this field."""
    pts = RNG.normal(0, 0.6, (50, 3)).astype(np.float32)
    for kw in ({}, {"texture_amp": 0.6, "texture_freq": 2.0}):
        want = jblob(None, jnp.asarray(pts), **kw)
        got = blob_field(t(pts), **kw)
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], 1e-5, 1e-5, k)
    img = RNG.uniform(0, 1, (7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(luminance_histogram(img), jhist(img))
    scene = make_synthetic_scene(n_views=3, H=8, W=10, focal=10.0,
                                 device="cpu")
    assert scene.images.shape == (3, 8, 10, 3) and scene.hists.shape == (
        3, 10)
    close(scene.poses, jscene_poses(3), 1e-6, 1e-7)


def jscene_poses(n_views, radius=2.5, seed=0):
    """The JAX make_synthetic_scene's cameras, without its render."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = np.array([radius * np.sin(ang), 0.4 + 0.2 * rng.standard_normal(),
                        radius * np.cos(ang)], dtype=np.float32)
        out.append(jlook_at(eye))
    return np.stack(out)


def test_stage0_loss_decreases():
    """The port's end-to-end training slice on its synthetic scene: 30
    random-ray steps of stage 0 at the JAX test's learning rate."""
    scene = make_synthetic_scene(n_views=8, H=24, W=32, device="cpu")
    model = NeFeSModel(ModelConfig.tiny(), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    st = create_train_state(model)
    cfg = model.cfg.render_config(n_samples=24, n_importance=24)
    batch = {"rgb": torch.from_numpy(scene.images[:4]),
             "poses": torch.from_numpy(scene.poses[:4]),
             "hists": torch.from_numpy(scene.hists[:4])}
    gen = torch.Generator().manual_seed(1)
    losses = []
    for step in range(30):
        _, loss, _ = train_step_rays(st, cfg, batch, gen,
                                     lr_for_epoch(step, 5e-3), scene.hwf,
                                     scene.near, scene.far, n_rand=128)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses


def test_stage1_on_synthetic_features():
    scene = make_synthetic_scene(n_views=4, H=24, W=32, device="cpu")
    feats = render_gt_features(scene, feature_dim=8, device="cpu")
    assert feats.shape == (4, 24, 32, 8) and np.isfinite(feats).all()
    model = NeFeSModel(ModelConfig.tiny(), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    st = create_train_state(model)
    batch = {"rgb": torch.from_numpy(scene.images),
             "poses": torch.from_numpy(scene.poses),
             "hists": torch.from_numpy(scene.hists),
             "feat": torch.from_numpy(feats)}
    cfg = model.cfg.render_config(n_samples=16, n_importance=16)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        _, loss, metrics = train_step_rays(st, cfg, batch, gen, 5e-3,
                                           scene.hwf, scene.near, scene.far,
                                           n_rand=64, stage=1)
        assert torch.isfinite(loss) and "loss_feat" in metrics
