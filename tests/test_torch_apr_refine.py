"""Mode-2 refinement with the APR zoo against the JAX package, on the CPU
in f32: refine_apr_single for 3 Adam steps (lr 1e-5) with PoseNetV2 on
running and on batch BN statistics and with MS-Transformer (1 + 1 layers,
Cambridge with a scene pose_avg), on a torch_parity field
(depth 2, width 32, 8 features) at 16 + 16 samples; the port through its
mode-2 kernel path (render_raw: K5/K7/K8's plain versions here), JAX
unfused.

* The standards of tests/test_torch_mode2.py: losses, PSNR, SSIM to 1e-5
  relative, the poses and apply_verification's pose to 5e-6 absolute,
  while the APR moves the pose by more than 1e-4. On batch statistics
  (PoseNetV2, freeze_bn False) the losses are held to 2e-4 of the first
  loss and the refined pose to 0.2 % of the move, test_torch_mode2.py's
  own reasoning for its 5e-6: Adam's first steps divide each gradient by
  its magnitude, so f32 noise in a near-zero component flips that
  weight's step, and batch statistics make the gradient noisier, by the
  number of torch threads (the summation order). Read: losses 6.7e-5 /
  2.4e-5 of the first loss apart with 2 / 8 threads, poses 4.5e-6 /
  3.6e-6 on a 5.6e-3 move (a bound of 1.1e-5); at 128x160 the losses
  parted by 6.6e-4 with 2 threads (ROADMAP Queue C).
* MS-Transformer's rotation comes from a quaternion, so it is orthogonal
  and svd_reg leaves the loss unchanged in exact arithmetic. The JAX
  package's refinement with svd_reg gives NaN from the second step there
  (jnp.linalg.svd's derivative divides by σi² - σj², 0 on a rotation;
  ROADMAP Queue C), so the port's run with svd_reg (its polar-factor
  derivative) is held to the JAX run without.
* The query is 240x320 (rendered at 60x80), 7-Scenes at half size:
  MobileNetV2's last stage then normalises 80 values a channel on batch
  statistics.
* The serving functions (refine_apr_verified, refine_apr_batch) repeat
  refine_apr_single with a zoo APR; an unknown kind raises.
* On the card (marked cuda): the captured loop against the eager one with
  PoseNetV2 and MS-Transformer.

Each APR starts where the render sees the scene: its last layer scaled
down, its biases the perturbed look-at pose of the mode-3 tests; the
target is the field's features at the true pose, upsampled.
"""

import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features import mstransformer as jms
from nefes_tpu.features import posenet as jpn
from nefes_tpu.geometry.se3 import rotmat_to_quat as jr2q
from nefes_tpu.refine.apr_opt import apply_verification as japply
from nefes_tpu.refine.apr_opt import refine_apr_single as jrefine
from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
from nefes_tpu.refine.pose_opt import render_feature_image as jrender
from nefes_tpu.utils.image import resize_bicubic as jbicubic
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.features import mstransformer as tms
from nefes_tpu_torch.features import posenet as tpn
from nefes_tpu_torch.geometry import learn_pose
from nefes_tpu_torch.refine import (
    RefineConfig, apply_verification, refine_apr_batch, refine_apr_single,
    refine_apr_verified,
)
from nefes_tpu_torch.weights import apr_from_jax_variables
from tests.test_torch_apr_zoo import jax_variables
from tests.torch_parity import close, configs, models, n, t

RNG = np.random.default_rng(14)
IMG_HW = (240, 320)
HWF_FULL, HWF_RENDER = (240, 320, 112.5), (60, 80, 28.125)
NEAR, FAR = 0.5, 4.0
WS = [1.0, 1.0, 0.0, 0.0, 0.0]
ITERS, LR = 3, 1e-5
RAW = dict(fused=True, fused_pre=False, fused_need_dw=False,
           fused_render=True)
PAS = np.array([[0.0, -1.0, 0.0, 0.3], [1.0, 0.0, 0.0, -0.2],
                [0.0, 0.0, 1.0, 0.1]], np.float32)      # a Cambridge scene


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads a test: the suite runs several workers at once on
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def start_pose() -> np.ndarray:
    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    return learn_pose(t([0.02, -0.03, 0.01]), t([0.05, -0.04, 0.03]),
                      t(gt))[:3, :4].numpy()


def ems_bias(pose: np.ndarray, dataset: str, pas) -> tuple:
    """The (t, quaternion) whose MS-Transformer output head gives pose:
    ems_pose_to_matrix inverted (on Cambridge, for a rigid pose_avg)."""
    if dataset == "Cambridge":
        c = np.diag([1.0, -1.0, -1.0]) @ np.concatenate(
            [pose[:, :1], -pose[:, 1:3], pose[:, 3:]], axis=1)
        hom = pas[:, :3] @ c
        hom[:, 3] += pas[:, 3]
        R, tr = hom[:, :3].T, hom[:, 3]
    else:
        R, tr = pose[:, :3], pose[:, 3]
    return tr, np.asarray(jr2q(jnp.asarray(R, jnp.float32)))


def aimed(kind: str, dataset: str = "7Scenes", pas=None, layers: int = 1):
    """(JAX module, its variables, the port's module with the same weights)
    of kind, the last layer aimed at start_pose()."""
    pose = start_pose()
    if kind == "PoseNetV2":
        jmod, tmod = jpn.PoseNetV2(), tpn.PoseNetV2(device="cpu")
    else:
        jmod = jms.MSTransPoseNet(layers=layers)
        tmod = tms.MSTransPoseNet(layers=layers, device="cpu")
    v = jax_variables(jmod, np.zeros((1, *IMG_HW, 3), np.float32), seed=3)
    p = v["params"]
    if kind == "PoseNetV2":
        p["fc_pose"]["kernel"] *= 0.05
        p["fc_pose"]["bias"] = pose.reshape(12)
    else:
        for name, bias in zip(("t", "rot"), ems_bias(pose, dataset, pas)):
            head = p[f"regressor_head_{name}"]
            head["fc_o_kernel"] *= 0.05
            head["fc_o_bias"][:] = bias
    tmod.load_state_dict(apr_from_jax_variables(v))
    return jmod, jax.tree.map(jnp.asarray, v), tmod


@pytest.fixture(scope="module")
def field():
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    kw = dict(n_samples=16, n_importance=16, output_transient=False,
              test_time=True, perturb=False, remat=False)
    jrc = jcfg.render_config(**kw)
    image = RNG.uniform(0, 1, IMG_HW + (3,)).astype(np.float32)
    # the target: the field's features at the true pose, at the query's size
    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    _, feat = jrender(jmodel, variables, jnp.asarray(gt), jnp.zeros(10),
                      HWF_RENDER, NEAR, FAR, jrc)
    target = np.asarray(jbicubic(feat[None], *IMG_HW)[0])
    return (jmodel, variables, jrc, tmodel,
            replace(tcfg.render_config(**kw), **RAW), image, target)


CASES = {   # kind, freeze_bn, dataset_type, pose_avg, the JAX svd_reg
    "posenetv2_running": ("PoseNetV2", True, "7Scenes", None, True),
    "posenetv2_batch": ("PoseNetV2", False, "7Scenes", None, True),
    "mstransformer_cambridge": ("MsTransformer", True, "Cambridge", PAS,
                                False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_refine_apr_single_zoo_matches_jax(field, case):
    kind, freeze_bn, dataset, pas, jsvd = CASES[case]
    jmodel, variables, jrc, tmodel, trc, image, target = field
    jmod, jv, tmod = aimed(kind, dataset, pas)
    want = jax.tree.map(np.asarray, jrefine(
        jmodel, variables, jmod, jv, jnp.asarray(image), jnp.asarray(target),
        jnp.zeros(10), jnp.asarray(WS), HWF_RENDER, HWF_FULL, NEAR, FAR, jrc,
        JRefine(opt_iter=ITERS, learning_rate=LR), svd_reg=jsvd,
        freeze_bn=freeze_bn, apr_kind=kind, dataset_type=dataset,
        pose_avg=None if pas is None else jnp.asarray(pas)))
    before = copy.deepcopy(tmod.state_dict())
    got = refine_apr_single(
        tmodel, tmod, t(image), t(target), torch.zeros(10), t(WS),
        HWF_RENDER, HWF_FULL, NEAR, FAR, trc,
        RefineConfig(opt_iter=ITERS, learning_rate=LR), freeze_bn=freeze_bn,
        apr_kind=kind, dataset_type=dataset, pose_avg=pas)
    for k, v in tmod.state_dict().items():       # the APR is left as it was
        assert torch.equal(v, before[k]), k
    if freeze_bn:
        close(got["losses"], want["losses"], 1e-5, 1e-6, "losses")
    else:
        close(got["losses"], want["losses"], 0, 2e-4 * want["losses"][0],
              "losses")
    for k in ("init_psnr", "end_psnr", "init_ssim", "end_ssim"):
        close(got[k], want[k], 1e-5, 1e-6, k)
    close(got["initial_pose"], want["initial_pose"], 0, 5e-6, "initial")
    moved = np.abs(want["refined_pose"] - want["initial_pose"]).max()
    assert moved > 1e-4, moved                 # the APR did move the pose
    tol = 5e-6 if freeze_bn else max(5e-6, 0.002 * moved)
    close(got["refined_pose"], want["refined_pose"], 0, tol, "refined")
    for metric in ("psnr_ssim", "dfm"):
        close(apply_verification(got, metric),
              japply(jax.tree.map(jnp.asarray, want), metric), 0, tol,
              metric)


def test_serving_functions_with_zoo(field):
    """refine_apr_verified and refine_apr_batch on the CPU repeat
    refine_apr_single for a zoo APR; an unknown kind raises."""
    _, _, _, tmodel, trc, image, target = field
    _, _, tmod = aimed("MsTransformer", "Cambridge", PAS)
    rcfg = RefineConfig(opt_iter=2, learning_rate=LR)
    args = (t(WS), HWF_RENDER, HWF_FULL, NEAR, FAR, trc, rcfg)
    kw = dict(apr_kind="MsTransformer", dataset_type="Cambridge",
              pose_avg=PAS)
    images = torch.stack([t(image), t(image).flip(0)])
    targets = torch.stack([t(target), t(target)])
    single = refine_apr_single(tmodel, tmod, images[1], targets[1],
                               torch.zeros(10), *args, **kw)
    batch = refine_apr_batch(tmodel, tmod, images, targets,
                             torch.zeros(2, 10), *args, **kw)
    for k, v in single.items():
        close(batch[k][1], v, 0, 0, k)
    pose = refine_apr_verified(tmodel, tmod, images, targets,
                               torch.zeros(2, 10), 1, 0, *args, **kw)
    close(pose, apply_verification(single), 0, 0)
    with pytest.raises(NotImplementedError):
        refine_apr_single(tmodel, tmod, images[0], targets[0],
                          torch.zeros(10), *args, apr_kind="NetVlad")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["PoseNetV2", "MsTransformer"])
def test_captured_zoo_matches_eager_on_card(cuda, field, kind):
    """The captured mode-2 loop against the eager one on the card with a
    zoo APR, through the raw kernels: losses within 1e-5 relative, poses
    within 5e-6 (cuDNN's convolution backward may sum in another order
    between the eager and the captured run)."""
    from nefes_tpu_torch.refine import refine_apr_captured
    _, _, _, tmodel, trc, image, target = field
    _, _, tmod = aimed(kind)
    model, apr = copy.deepcopy(tmodel).to(cuda), tmod.to(cuda)
    args = (model, apr, t(image).to(cuda), t(target).to(cuda),
            torch.zeros(10, device=cuda), t(WS).to(cuda), HWF_RENDER,
            HWF_FULL, NEAR, FAR, trc,
            RefineConfig(opt_iter=3, learning_rate=LR))
    kw = dict(apr_kind=kind, freeze_bn=kind != "PoseNetV2")
    want = refine_apr_single(*args, **kw)
    for _ in range(2):                       # capture, then replay only
        got = refine_apr_captured(*args, **kw)
        for k in ("losses", "init_psnr", "end_psnr", "init_ssim",
                  "end_ssim"):
            close(got[k].cpu(), want[k].cpu(), 1e-5, 1e-6, k)
        for k in ("refined_pose", "initial_pose"):
            close(n(got[k].cpu()), n(want[k].cpu()), 0, 5e-6, k)
