"""The port's mode-2 refinement (APR-weight optimisation through DFNet)
against the JAX package, on the CPU in f32 at a small size.

* DFNet's features (running and batch BN statistics) and pose, the
  resizes, SSIM, PSNR and the SVD re-orthogonalisation with its gradient
  equal their JAX functions: values to 1e-5 of their scale (1e-4 for the
  VGG16 outputs and gradients, which sum over more terms).
* A 3-step refine_apr_single on a 48×64 query, rendered at 12×16, gives
  the losses, PSNR, SSIM and refined pose of ONE JAX unfused run, through
  the port's unfused path and its kernel paths (render_raw: K5/K7/K8,
  fused_raw: K5/K6, render_pre: K1/K3/K4; their plain versions on the
  CPU). Tolerances: losses, PSNR, SSIM to 1e-5 relative; the pose to
  5e-6, under 0.2 % of the 3.5e-3 the APR moves it in these steps (the
  gap read 1.2e-6). Adam's first steps divide each gradient by its own
  magnitude, so f32 noise in a near-zero gradient component can flip
  that weight's step; the bound holds that well below the movement.
* apply_verification's three metrics equal JAX's on single and batched
  results.

The APR starts where the render sees the scene: fc_pose's weight scaled
down and its bias set to the perturbed look-at pose of the mode-3 tests.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features.dfnet import DFNet as JDFNet
from nefes_tpu.features.dfnet import extract_target_features as jextract
from nefes_tpu.geometry.se3 import orthogonalize_rotation as jortho
from nefes_tpu.refine.apr_opt import apply_verification as japply
from nefes_tpu.refine.apr_opt import refine_apr_single as jrefine_apr
from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
from nefes_tpu.train.losses import psnr as jpsnr
from nefes_tpu.utils.image import resize_bicubic as jbicubic
from nefes_tpu.utils.image import resize_bilinear as jbilinear
from nefes_tpu.utils.ssim import ssim as jssim
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.features import DFNet, extract_target_features
from nefes_tpu_torch.geometry import learn_pose, orthogonalize_rotation
from nefes_tpu_torch.refine import (
    RefineConfig, apply_verification, refine_apr_batch, refine_apr_single,
    refine_apr_verified,
)
from nefes_tpu_torch.train.losses import psnr
from nefes_tpu_torch.utils import resize_bicubic, resize_bilinear, ssim
from nefes_tpu_torch.weights import dfnet_from_jax_variables
from tests.torch_parity import close, configs, models, n, t

RNG = np.random.default_rng(4)
IMG_HW = (48, 64)
HWF_FULL, HWF_RENDER = (48, 64, 22.0), (12, 16, 22.0 / 4)
NEAR, FAR = 0.5, 4.0
WS = [1.0, 1.0, 0.0, 0.0, 0.0]
ITERS, LR = 3, 1e-5
PATHS = {
    "unfused": dict(fused=False),
    "render_raw": dict(fused=True, fused_pre=False, fused_need_dw=False,
                       fused_render=True),
    "fused_raw": dict(fused=True, fused_pre=False, fused_need_dw=False,
                      fused_render=False),
    "render_pre": dict(fused=True, fused_pre=True, fused_need_dw=False,
                       fused_render=True),
}


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-6)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def dfnets():
    """(JAX DFNet, its variables, the port's DFNet with the same weights,
    the query image). Random BN statistics; fc_pose aimed at the scene."""
    image = RNG.uniform(0, 1, IMG_HW + (3,)).astype(np.float32)
    jd = JDFNet(output_dim=8)
    v = jax.tree.map(np.asarray, jd.init(jax.random.key(0), image[None]))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    for blk in v["batch_stats"].values():
        blk["bn"]["mean"] = RNG.normal(0, 0.1, blk["bn"]["mean"].shape)
        blk["bn"]["var"] = RNG.uniform(0.5, 1.5, blk["bn"]["var"].shape)
    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    pert = learn_pose(t([0.02, -0.03, 0.01]), t([0.05, -0.04, 0.03]),
                      t(gt))[:3, :4].numpy()
    v["params"]["fc_pose"]["kernel"] = v["params"]["fc_pose"]["kernel"] * 0.05
    v["params"]["fc_pose"]["bias"] = pert.reshape(12)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), v)
    td = DFNet(output_dim=8, device="cpu")
    td.load_state_dict(dfnet_from_jax_variables(v))
    return jd, jax.tree.map(jnp.asarray, v), td, image


# --- modules ---

@pytest.mark.parametrize("train_bn", [False, True],
                         ids=["running_bn", "batch_bn"])
def test_dfnet_features_and_pose(dfnets, train_bn):
    jd, jv, td, image = dfnets
    (jf, jp) = jd.apply(jv, jnp.asarray(image)[None], upsample_hw=IMG_HW,
                        train_bn=train_bn, mutable=["batch_stats"])[0] \
        if train_bn else jd.apply(jv, jnp.asarray(image)[None],
                                  upsample_hw=IMG_HW)
    before = {k: v.clone() for k, v in td.state_dict().items()}
    with torch.no_grad():
        tf, tp = td(t(image)[None], upsample_hw=IMG_HW, train_bn=train_bn)
    for k, v in td.state_dict().items():       # running stats untouched
        assert torch.equal(v, before[k]), k
    assert tf.shape == (3, 1) + IMG_HW + (8,)
    for lv in range(3):
        _scaled_close(tf[lv], jf[lv], 1e-4, f"level {lv}")
    _scaled_close(tp, jp, 1e-4, "pose")
    with torch.no_grad():
        target = extract_target_features(td, t(image)[None], 24, 32,
                                         levels=(0, 2))
    want = jextract(jd, jv, jnp.asarray(image)[None], 24, 32, levels=(0, 2))
    assert target.shape == (1, 24, 32, 16)
    _scaled_close(target, want, 1e-4, "target features")
    with pytest.raises(AssertionError):
        td(torch.zeros(1, 16, 64, 3))           # pose head needs >= 32 px


@pytest.mark.parametrize("op", ["bicubic_up", "bicubic_down",
                                "bilinear_corners", "bilinear_half"])
def test_resize(op):
    img = RNG.normal(0, 1, (2, 12, 16, 5)).astype(np.float32)
    w = RNG.normal(0, 1, (2, 48, 64, 5) if op != "bicubic_down"
                   else (2, 5, 7, 5)).astype(np.float32)
    H, W = w.shape[1:3]
    jfn, tfn = {
        "bicubic_up": (jbicubic, resize_bicubic),
        "bicubic_down": (jbicubic, resize_bicubic),
        "bilinear_corners": (lambda x, h, v: jbilinear(x, h, v, True),
                             lambda x, h, v: resize_bilinear(x, h, v, True)),
        "bilinear_half": (jbilinear, resize_bilinear),
    }[op]
    want, jg = jax.value_and_grad(
        lambda x: jnp.sum(jfn(x, H, W) * w), has_aux=False)(jnp.asarray(img))
    x = t(img, True)
    out = tfn(x, H, W)
    assert out.shape == (2, H, W, 5)
    (out * t(w)).sum().backward()
    close(out.detach().mul(t(w)).sum(), want, 1e-5, 1e-5)
    close(tfn(t(img), H, W), jfn(jnp.asarray(img), H, W), 1e-5, 1e-5)
    _scaled_close(x.grad, jg, 1e-5, "grad")


def test_ssim_and_psnr():
    x = RNG.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    y = np.clip(x + RNG.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    close(ssim(t(x), t(y)), jssim(jnp.asarray(x), jnp.asarray(y)), 1e-5,
          1e-5, "ssim")
    close(psnr(t(x), t(y)), jpsnr(jnp.asarray(x), jnp.asarray(y)), 1e-5,
          1e-5, "psnr")


def test_orthogonalize_rotation_and_grad():
    """A near-rotation with distinct singular values (the case a random
    APR gives); the gradient of a weighted sum of U Vᵀ and t."""
    pose = RNG.normal(0, 1, (2, 3, 4)).astype(np.float32)
    pose[:, :, :3] = pose[:, :, :3] * 0.2 + np.eye(3, dtype=np.float32)
    w = RNG.normal(0, 1, (2, 3, 4)).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda p: jnp.sum(jortho(p) * w))(jnp.asarray(pose))
    x = t(pose, True)
    out = orthogonalize_rotation(x)
    R = out[:, :, :3].detach()
    close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(3), (2, 3, 3)), 1e-5,
          1e-5, "orthonormal")
    close(out, jortho(jnp.asarray(pose)), 1e-5, 1e-5, "values")
    (out * t(w)).sum().backward()
    _scaled_close(x.grad, jg, 1e-4, "grad")


def test_apply_verification_matches_jax():
    base = {"refined_pose": np.ones((3, 4)), "initial_pose": np.zeros((3, 4)),
            "init_psnr": 10.0, "end_psnr": 15.0, "init_ssim": 0.5,
            "end_ssim": 0.7, "losses": np.array([0.5, 0.4, 0.3])}
    cases = [base,
             {**base, "losses": np.array([0.3, 0.4, 0.5])},   # dfm worse
             {**base, "end_psnr": 5.0},                        # psnr worse
             {**base, "end_ssim": 0.2},                        # ssim worse
             {"refined_pose": np.ones((2, 3, 4)),              # batched
              "initial_pose": np.zeros((2, 3, 4)),
              "init_psnr": np.array([10.0, 10.0]),
              "end_psnr": np.array([15.0, 9.0]),
              "init_ssim": np.array([0.5, 0.5]),
              "end_ssim": np.array([0.7, 0.7]),
              "losses": np.array([[0.5, 0.3], [0.3, 0.5]])}]
    for case in cases:
        for metric in ("psnr_ssim", "dfm", "either"):
            tcase = {k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in case.items()}
            jcase = {k: jnp.asarray(np.asarray(v, np.float32))
                     for k, v in case.items()}
            close(apply_verification(tcase, metric), japply(jcase, metric),
                  0, 0, metric)
    with pytest.raises(ValueError):
        apply_verification(base, "neither")


# --- the refinement loop ---

@pytest.fixture(scope="module")
def setup(dfnets):
    jd, jv, td, image = dfnets
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    kw = dict(n_samples=16, n_importance=16, output_transient=False,
              test_time=True, perturb=False, remat=False)
    with torch.no_grad():
        target = extract_target_features(td, t(image)[None], *IMG_HW)[0]
    return (jmodel, variables, jcfg.render_config(**kw), tmodel,
            tcfg.render_config(**kw), target)


@pytest.fixture(scope="module")
def jax_mode2(dfnets, setup):
    """JAX's unfused mode-2 run (one jit of the VGG16 loop)."""
    jd, jv, _, image = dfnets
    jmodel, variables, jrc, _, _, target = setup
    out = jrefine_apr(jmodel, variables, jd, jv, jnp.asarray(image),
                      jnp.asarray(n(target)), jnp.zeros(10), jnp.asarray(WS),
                      HWF_RENDER, HWF_FULL, NEAR, FAR, jrc,
                      JRefine(opt_iter=ITERS, learning_rate=LR))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("path", list(PATHS))
def test_refine_apr_matches_jax(dfnets, setup, jax_mode2, path):
    _, _, td, image = dfnets
    _, _, _, tmodel, trc, target = setup
    want = jax_mode2
    before = [p.clone() for p in td.parameters()]
    got = refine_apr_single(tmodel, td, t(image), target, torch.zeros(10),
                            t(WS), HWF_RENDER, HWF_FULL, NEAR, FAR,
                            replace(trc, **PATHS[path]),
                            RefineConfig(opt_iter=ITERS, learning_rate=LR))
    assert all(torch.equal(a, b) for a, b in zip(td.parameters(), before))
    assert got["losses"].shape == (ITERS,)
    close(got["losses"], want["losses"], 1e-5, 1e-6, "losses")
    for k in ("init_psnr", "end_psnr", "init_ssim", "end_ssim"):
        close(got[k], want[k], 1e-5, 1e-6, k)
    close(got["initial_pose"], want["initial_pose"], 1e-6, 1e-6, "initial")
    moved = np.abs(want["refined_pose"] - want["initial_pose"]).max()
    assert moved > 1e-3, moved                 # the APR did move the pose
    close(got["refined_pose"], want["refined_pose"], 0, 5e-6,
          "refined pose")


def test_refine_apr_batch_and_verified(dfnets, setup, jax_mode2):
    """The batch loop and the serving step repeat refine_apr_single."""
    _, _, td, image = dfnets
    _, _, _, tmodel, trc, target = setup
    rcfg = RefineConfig(opt_iter=2, learning_rate=LR)
    args = (t(WS), HWF_RENDER, HWF_FULL, NEAR, FAR, trc, rcfg)
    images = torch.stack([t(image), t(image).flip(0)])
    targets = torch.stack([target, target])
    batch = refine_apr_batch(tmodel, td, images, targets, torch.zeros(2, 10),
                             *args)
    assert batch["refined_pose"].shape == (2, 3, 4)
    assert batch["losses"].shape == (2, 2)
    single = refine_apr_single(tmodel, td, images[1], target,
                               torch.zeros(10), *args)
    for k, v in single.items():
        close(batch[k][1], v, 0, 0, k)
    pose = refine_apr_verified(tmodel, td, images, targets,
                               torch.zeros(2, 10), 1, 0, *args)
    close(pose, apply_verification(single), 0, 0)
    with pytest.raises(NotImplementedError):
        refine_apr_single(tmodel, td, images[0], target, torch.zeros(10),
                          *args, apr_kind="NetVlad")
