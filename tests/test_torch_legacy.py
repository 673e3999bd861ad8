"""The port's legacy DFM toolbox (nefes_tpu_torch/refine/legacy_train.py)
and homography warp (nefes_tpu_torch/utils/homography.py) against the
JAX package's, on the CPU in f32, the same numpy-seeded inputs through
both:

* every triplet loss, the masked MSE and their gradients to 1e-6 of
  their scale; the hard-negative variants choose the branch the numpy
  cases choose, over inputs that reach every branch of both variants,
  and the loss is that branch's;
* the pose perturbations and the homography draws equal, from the same
  seed (numpy in both);
* render_nerfw_imgs through the raw-input kernels' plain versions (K5 +
  K7) to 1e-4 (the render tolerance of tests/test_torch_validation.py),
  get_validation_loss's options to 1e-6 (absolute for the cosine loss,
  1 - a mean of cosines, relative for the others);
* grid_sample on coordinates that fall on the border, outside it and on
  exact half pixels: nearest equal to the bit (both round half to even),
  bilinear to 1e-6; its gradient, the inverse warp, the valid mask (with
  and without erosion) and create_warped_img.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

from nefes_tpu.refine import legacy_train as jl
from nefes_tpu.utils import homography as jh
from nefes_tpu_torch.refine import legacy_train as tl
from nefes_tpu_torch.utils import homography as th
from tests.torch_parity import close, configs, models, n, t

SHAPES = [(2, 4, 6, 5, 7), (4, 6, 5, 7)]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _value_and_grads(tfn, jfn, *arrays):
    """(port value, port grads, JAX value, JAX grads) of a scalar loss of
    the arrays."""
    ts = [t(a, True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return tv, [x.grad for x in ts], jv, jg


def _close_scaled(got, want, tol, msg):
    scale = max(float(np.abs(n(want)).max()), 1e-30)
    close(n(got) / scale, n(want) / scale, 0, tol, msg)


def _check(tfn, jfn, *arrays, msg=""):
    tv, tg, jv, jg = _value_and_grads(tfn, jfn, *arrays)
    close(tv, jv, 1e-6, 0, msg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close_scaled(a, b, 1e-6, f"{msg} grad {i}")
    return tv


@pytest.mark.parametrize("shape", SHAPES)
def test_triplet_losses_and_grads_match_jax(shape):
    for seed in range(3):
        f1, f2 = _pair(shape, seed)
        neg = np.roll(f2, 1, axis=0)
        _check(tl.triplet_margin_loss, jl.triplet_margin_loss, f1, f2, neg,
               msg="margin")
        if len(shape) == 5:
            _check(tl.triplet_loss, jl.triplet_loss, f1, f2, msg="roll")


def _cases(f1, f2, axis):
    a, p = f1.astype(np.float64), f2.astype(np.float64)
    an, ng = np.roll(a, 1, axis=axis), np.roll(p, 1, axis=axis)
    return [np.mean((a - ng) ** 2), np.mean((p - an) ** 2),
            np.mean((a - an) ** 2), np.mean((p - ng) ** 2)]


def _branches(f1, f2, axis):
    a, p = t(f1), t(f2)
    an, ng = torch.roll(a, 1, dims=axis), torch.roll(p, 1, dims=axis)
    m = tl.triplet_margin_loss
    return [m(a, p, ng), m(p, a, an), m(a, p, an), m(p, a, ng)]


def test_hard_negative_mining_branches_match_jax():
    """2-case variant on (L, B, ...) pairs; one of the two inputs scaled
    so that each branch is reached."""
    chosen = set()
    for seed in range(6):
        f1, f2 = _pair(SHAPES[0], seed)
        f1 = f1 * (0.5 if seed % 2 else 2.0)
        got = _check(tl.triplet_loss_hard_negative_mining,
                     jl.triplet_loss_hard_negative_mining, f1, f2, msg="hnm")
        c = _cases(f1, f2, 1)
        k = 0 if c[0] < c[1] else 1
        chosen.add(k)
        assert float(got.detach()) == float(_branches(f1, f2, 1)[k])
    assert chosen == {0, 1}


@pytest.mark.parametrize("shape", SHAPES)
def test_hard_negative_mining_plus_branches_match_jax(shape):
    axis = 1 if len(shape) == 5 else 0
    chosen = set()
    for seed in range(8):
        f1, f2 = _pair(shape, seed + 10)
        # make case seed % 4 the least: its two tensors nearly equal
        k = seed % 4
        if k == 0:      # the anchor and the rolled positive
            f2 = np.roll(f1, -1, axis=axis) + 0.1 * f2
        elif k == 1:    # the positive and the rolled anchor
            f1 = np.roll(f2, -1, axis=axis) + 0.1 * f1
        elif k == 2:    # the anchor and its roll
            f1 = np.take(f1, [0], axis=axis) + 0.1 * f1
        else:           # the positive and its roll
            f2 = np.take(f2, [0], axis=axis) + 0.1 * f2
        got = _check(tl.triplet_loss_hard_negative_mining_plus,
                     jl.triplet_loss_hard_negative_mining_plus, f1, f2,
                     msg="hnm+")
        assert int(np.argmin(_cases(f1, f2, axis))) == k
        chosen.add(k)
        assert float(got.detach()) == float(_branches(f1, f2, axis)[k])
    assert chosen == {0, 1, 2, 3}


def test_masked_mse_and_grads_match_jax():
    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    f2 = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    mask = (rng.uniform(size=(2, 6, 8)) > 0.4).astype(np.float32)
    _check(lambda a, b: tl.masked_mse_loss(a, b, t(mask)),
           lambda a, b: jl.masked_mse_loss(a, b, jnp.asarray(mask)), f1, f2,
           msg="masked mse")
    empty = np.zeros_like(mask)
    close(tl.masked_mse_loss(t(f1), t(f2), t(empty)),
          jl.masked_mse_loss(jnp.asarray(f1), jnp.asarray(f2),
                             jnp.asarray(empty)), 0, 0, "empty mask")


def test_pose_perturbations_match_jax():
    pose = np.concatenate([np.eye(3), [[0.5], [0.2], [1.0]]], axis=1)
    for fn in ("perturb_single_render_pose",
               "perturb_single_render_pose_norm"):
        got = getattr(tl, fn)(pose, 0.1, 5.0, np.random.default_rng(4))
        want = getattr(jl, fn)(pose, 0.1, 5.0, np.random.default_rng(4))
        np.testing.assert_array_equal(got, want, err_msg=fn)
    np.testing.assert_array_equal(tl.perturb_rotation(pose, 10.0, 3.0, 1.0),
                                  jl.perturb_rotation(pose, 10.0, 3.0, 1.0))


def test_render_nerfw_imgs_and_validation_loss_match_jax():
    from nefes_tpu.data.synthetic import make_synthetic_scene
    scene = make_synthetic_scene(n_views=2, H=16, W=16)
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    kw = dict(n_samples=4, n_importance=4, perturb=False,
              output_transient=False)
    jrc = jcfg.render_config(**kw).test()
    trc = replace(tcfg.render_config(**kw).test(), fused=True,
                  fused_pre=False, fused_need_dw=False, fused_render=True)
    hwf = (16, 16, float(scene.focal))
    want = jl.render_nerfw_imgs(jmodel, variables, scene.poses, scene.hists,
                                hwf, scene.near, scene.far, jrc)
    got = tl.render_nerfw_imgs(tmodel, scene.poses, scene.hists, hwf,
                               scene.near, scene.far, trc)
    assert got.shape == (2, 16, 16, 3)
    close(got, want, 0, 1e-4, "renders")

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    other = feats + rng.normal(0, 0.3, feats.shape).astype(np.float32)
    opts = ("pose", "feature_mse", "feature_triplet",
            "feature_cosine_similarity")
    jv = jl.get_validation_loss(want, scene.images, feats, other, opts)
    tv = tl.get_validation_loss(got, scene.images, feats, other, opts)
    assert set(tv) == set(jv) == {"pose", "feature_mse", "feature_triplet",
                                  "feature_cos"}
    tv2 = tl.get_validation_loss(want, scene.images, feats, other, opts)
    for k in jv:
        tol = dict(abs=1e-6) if k == "feature_cos" else dict(rel=1e-6)
        assert tv2[k] == pytest.approx(jv[k], **tol), k
        assert np.isfinite(tv[k])


# --- homography ---

H, W = 5, 9      # (H-1, W-1) powers of 2: half pixels exact in [-1, 1]


def _coords():
    """(1, 2H + 3, 2W + 3, 2) normalised coordinates at pixel positions
    from one before each border to one past it, by half pixels: the
    border, outside it and the ties."""
    px = np.arange(-2, 2 * W + 1) / 2.0                   # -1 .. W, by .5
    py = np.arange(-2, 2 * H + 1) / 2.0
    gx, gy = np.meshgrid(px, py)
    c = np.stack([gx / (W - 1) * 2 - 1, gy / (H - 1) * 2 - 1], -1)
    return c[None].astype(np.float32)


def test_grid_sample_border_and_half_pixels_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    coords = _coords()
    # the positions are exact: the ties are ties
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    assert np.any(x % 1 == 0.5) and x.min() < 0 and x.max() > W - 1
    near_t = th.grid_sample(t(img), t(coords), mode="nearest")
    near_j = jh.grid_sample(jnp.asarray(img), jnp.asarray(coords),
                            mode="nearest")
    np.testing.assert_array_equal(n(near_t), np.asarray(near_j))
    bil = th.grid_sample(t(img), t(coords))
    close(bil, jh.grid_sample(jnp.asarray(img), jnp.asarray(coords)), 0,
          1e-6, "bilinear")
    rand = rng.uniform(-1.3, 1.3, size=(2, 5, 7, 2)).astype(np.float32)
    img2 = rng.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    w = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)

    def jf(im):
        return jnp.sum(jh.grid_sample(im, jnp.asarray(rand)) * w)
    x2 = t(img2, True)
    (th.grid_sample(x2, t(rand)) * t(w)).sum().backward()
    _close_scaled(x2.grad, jax.grad(jf)(jnp.asarray(img2)), 1e-6, "grad")


def test_warp_mask_and_homography_draws_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    hs = np.stack([jh.sample_homography_np(np.array([2, 2]), shift=-1,
                                           rng=np.random.default_rng(s))
                   for s in range(3)])
    for s in range(3):
        np.testing.assert_array_equal(
            th.sample_homography_np(np.array([2, 2]), shift=-1,
                                    rng=np.random.default_rng(s)), hs[s])
    pts1 = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float64)
    pts2 = pts1 + rng.uniform(-0.2, 0.2, (4, 2))
    np.testing.assert_array_equal(th.four_point_homography(pts1, pts2),
                                  jh.four_point_homography(pts1, pts2))
    close(th.warp_points(t(pts), t(hs)),
          jh.warp_points(jnp.asarray(pts), jnp.asarray(hs, jnp.float32)),
          1e-6, 1e-6, "warp_points")
    img = rng.uniform(size=(3, 12, 16, 2)).astype(np.float32)
    close(th.inv_warp_image_batch(t(img), t(hs)),
          jh.inv_warp_image_batch(jnp.asarray(img),
                                  jnp.asarray(hs, jnp.float32)),
          0, 1e-5, "inv_warp")
    for radius in (0, 2):
        np.testing.assert_array_equal(
            n(th.compute_valid_mask((12, 16), t(hs), radius)),
            np.asarray(jh.compute_valid_mask((12, 16),
                                             jnp.asarray(hs, jnp.float32),
                                             radius)), err_msg=str(radius))
    got, gh = th.create_warped_img(t(img), 3, np.random.default_rng(7))
    want, jhm = jh.create_warped_img(jnp.asarray(img), 3,
                                     np.random.default_rng(7))
    np.testing.assert_array_equal(n(gh), np.asarray(jhm))
    close(got, want, 0, 1e-5, "create_warped_img")
