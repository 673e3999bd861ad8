"""Tests that need the card (marked cuda; each skips without one), in a
file that imports no JAX: the machine with the card has none. There, from
the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q

(--noconftest: tests/conftest.py imports JAX.) Every model is the port's
own, with seeded random weights.

1. The captured mode-2 loop against the eager one with a zoo APR
   (PoseNetV2 on batch BN statistics, MS-Transformer on running ones)
   through the raw kernels (K5, K7, K8), without svd_reg (the captured
   loop's polar iteration is not the eager SVD) and on cuDNN's
   deterministic algorithms: losses, PSNR and SSIM within 1e-5 relative,
   the poses within 5e-6.
2. The field zoo's first training step on the card against the CPU's,
   from the same weights and pixels (perturb off), each kind at the
   training CLI's widths (D8/W128; 16 hash levels of 2^19 rows, bound 25;
   N_vocab 1000) on 4 x 256 rays of 64 + 64 samples, held against how far
   the CPU's own step moves when the poses move by one rounding (times
   1 + 2^-23 x a normal draw): the card reaches the CPU's last bits in
   another order (fused multiply-adds in the ray points, other sums, the
   tables' unordered scatter-add), and the frequency embedding multiplies
   a point's last bit by up to 2^9 before its sin / cos. The loss and
   all parameters after one Adam step (relative L2) must sit within 10
   times the CPU's own move, or 1e-5; each gradient (relative L2) within
   10 times, or 1e-2 (the hash tables' rows each sum up to ~1e5
   contributions in the card's unordered scatter: 2.3e-4 to 2.2e-3 on an
   H100). The hash field starts from a visible density (sigma_out's bias
   5): at its near-zero initial density 1 - exp(-delta sigma) keeps few
   bits, which the card's exp and the CPU's round differently.
"""

import copy

import numpy as np
import pytest
import torch

from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.features import load_apr
from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.geometry import learn_pose
from nefes_tpu_torch.geometry.se3 import rotmat_to_quat
from nefes_tpu_torch.refine import (
    RefineConfig, refine_apr_captured, refine_apr_single,
    render_feature_image,
)
from nefes_tpu_torch.train import create_train_state, rays_loss
from nefes_tpu_torch.train.field_zoo import ZooConfig, ZooFieldModel
from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
from nefes_tpu_torch.train.trainer import apply_gradients
from nefes_tpu_torch.utils.image import resize_bicubic

IMG_HW = (240, 320)
HWF_FULL, HWF_RENDER = (240, 320, 112.5), (60, 80, 28.125)
NEAR, FAR = 0.5, 4.0
WS = [1.0, 1.0, 0.0, 0.0, 0.0]
LR_APR = 1e-5
RAW = dict(fused=True, fused_pre=False, fused_need_dw=False,
           fused_render=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=msg)


def _start_pose() -> torch.Tensor:
    gt = torch.from_numpy(look_at_pose(np.array([0.0, 0.3, 2.4],
                                                np.float32)))
    return learn_pose(torch.tensor([0.02, -0.03, 0.01]),
                      torch.tensor([0.05, -0.04, 0.03]), gt)[:3, :4]


@torch.no_grad()
def _aimed(kind: str, dev):
    """A zoo APR (seeded random weights) whose last layer is scaled down
    and whose biases give the start pose (7-Scenes)."""
    apr, _ = load_apr(kind, None, IMG_HW, torch.Generator().manual_seed(3),
                      device=dev)
    pose = _start_pose().to(dev)
    if kind == "MsTransformer":
        apr.scene_embed.weight.zero_()
        q = rotmat_to_quat(pose[:, :3])
        for head, bias in ((apr.regressor_head_t, pose[:, 3]),
                           (apr.regressor_head_rot, q)):
            head.fc_o_kernel.mul_(0.05)
            head.fc_o_bias.copy_(bias.expand_as(head.fc_o_bias))
    else:
        apr.fc_pose.weight.mul_(0.05)
        apr.fc_pose.bias.copy_(pose.reshape(12))
    return apr.requires_grad_(False)


@pytest.fixture
def field(cuda):
    """The small NeFeS field (depth 2, width 32, 8 features) on the card,
    its mode-2 render config, a query and the field's features at the
    true pose upsampled to the query's size as the target."""
    cfg = ModelConfig(depth=2, width=32, feature_dim=8, skips=(1,),
                      xyz_embed=EmbedConfig(num_freqs=4),
                      dir_embed=EmbedConfig(num_freqs=2))
    model = NeFeSModel(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    kw = dict(n_samples=16, n_importance=16, output_transient=False,
              test_time=True, perturb=False, remat=False)
    gt = torch.from_numpy(look_at_pose(np.array([0.0, 0.3, 2.4],
                                                np.float32))).to(cuda)
    with torch.no_grad():
        _, feat = render_feature_image(model, gt[:3, :4],
                                       torch.zeros(10, device=cuda),
                                       HWF_RENDER, NEAR, FAR,
                                       cfg.render_config(**kw))
        target = resize_bicubic(feat[None], *IMG_HW)[0]
    image = torch.rand(IMG_HW + (3,),
                       generator=torch.Generator().manual_seed(14)).to(cuda)
    return model, cfg.render_config(**kw, **RAW), image, target


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["PoseNetV2", "MsTransformer"])
def test_captured_zoo_matches_eager_on_card(cuda, field, kind):
    model, trc, image, target = field
    apr = _aimed(kind, cuda)
    args = (model, apr, image, target, torch.zeros(10, device=cuda),
            torch.tensor(WS, device=cuda), HWF_RENDER, HWF_FULL, NEAR, FAR,
            trc, RefineConfig(opt_iter=3, learning_rate=LR_APR))
    # without svd_reg: with it the captured loop orthogonalises by the
    # polar iteration and the eager one by the SVD, which part in the
    # last bits (chip_smoke.py's apr phase runs without it too)
    kw = dict(apr_kind=kind, freeze_bn=kind != "PoseNetV2", svd_reg=False)
    torch.backends.cudnn.deterministic = True
    try:
        want = refine_apr_single(*args, **kw)
        for _ in range(2):                   # capture, then replay only
            got = refine_apr_captured(*args, **kw)
            for k in ("losses", "init_psnr", "end_psnr", "init_ssim",
                      "end_ssim"):
                _close(got[k], want[k], 1e-5, 1e-6, k)
            for k in ("refined_pose", "initial_pose"):
                _close(got[k], want[k], 0, 5e-6, k)
    finally:
        torch.backends.cudnn.deterministic = False


def zoo_step(model, rcfg, batch, idx, hwf, lr):
    """One random-ray step of `model` at flat pixel indices idx (B, N):
    (loss, {name: gradient}, {name: parameter after the step})."""
    state = create_train_state(model)
    gen = torch.Generator(device=batch["poses"].device).manual_seed(0)
    loss, _ = rays_loss(model, rcfg, batch, idx, gen, hwf, NEAR, FAR)
    apply_gradients(state, loss, lr)
    return (loss.detach(),
            {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()},
            {k: p.detach() for k, p in model.named_parameters()})


def apart(step, ref) -> dict:
    """How far a step (loss, gradients, parameters) is from the reference
    step: the loss's relative difference, each gradient's relative L2,
    all parameters' relative L2."""
    (l, g, p), (lr_, gr, pr) = step, ref

    def rl2(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).norm() / b.norm()) if b.norm() > 0 else 0.0
    num = sum(float((p[k].cpu().double() - pr[k].cpu().double()).pow(2)
                    .sum()) for k in pr)
    den = sum(float(pr[k].cpu().double().pow(2).sum()) for k in pr)
    return {"loss": abs(float(l) - float(lr_)) / abs(float(lr_)),
            "grads": {k: rl2(g[k], gr[k]) for k in gr},
            "params": (num / den) ** 0.5}


def zoo_batch(B: int, H: int, W: int, n: int, seed: int = 0):
    """Random targets (seed), B poses around the scene, histograms of
    bin values 0-99, and n distinct pixels per image, on the CPU:
    (batch, idx)."""
    rng = np.random.default_rng(seed)
    eyes = [(2.4 * np.sin(a), 0.3, 2.4 * np.cos(a))
            for a in np.linspace(0.0, 1.2, B)]
    batch = {"rgb": torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3))
                                     .astype(np.float32)),
             "poses": torch.from_numpy(np.stack([
                 look_at_pose(np.array(e, np.float32)) for e in eyes])),
             "hists": torch.from_numpy(rng.integers(0, 100, (B, 10))
                                       .astype(np.float32))}
    idx = torch.from_numpy(np.stack([rng.choice(H * W, n, replace=False)
                                     for _ in range(B)]))
    return batch, idx


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hash", "nerfw", "nerf"])
def test_zoo_first_step_card_matches_cpu(cuda, kind):
    cfg = ZooConfig(kind=kind)
    cpu_model = ZooFieldModel(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    if kind == "hash":
        # a visible density, as a few hundred steps would give: the
        # tables start near 0 and so does the ReLU density, where
        # 1 - exp(-delta sigma) keeps few bits, which the card's exp and
        # the CPU's round differently
        with torch.no_grad():
            for tower in (cpu_model.coarse, cpu_model.fine):
                tower.sigma_out.bias[0] = 5.0
    card_model = copy.deepcopy(cpu_model).to(cuda)
    jitter_model = copy.deepcopy(cpu_model)
    rcfg = cfg.render_config(n_samples=64, n_importance=64, perturb=False,
                             remat=False)
    hwf, lr = (60, 80, 525.505 / 8), 5e-4
    batch, idx = zoo_batch(4, 60, 80, 256)
    jittered = dict(batch, poses=batch["poses"] * (1.0 + 2.0 ** -23 * (
        torch.randn(batch["poses"].shape,
                    generator=torch.Generator().manual_seed(9)))))
    card, cpu, jit = (
        zoo_step(model, rcfg, {k: v.to(dev) for k, v in b.items()},
                 idx.to(dev), hwf, lr)
        for model, b, dev in ((card_model, batch, cuda),
                              (cpu_model, batch, "cpu"),
                              (jitter_model, jittered, "cpu")))
    got, own = apart(card, cpu), apart(jit, cpu)

    def tol(x, floor=1e-5):
        return max(floor, 10.0 * x)
    print(kind, {"loss": (got["loss"], own["loss"]),
                 "params": (got["params"], own["params"]),
                 "grads": max((got["grads"][k], own["grads"][k])
                              for k in got["grads"])})
    assert got["loss"] <= tol(own["loss"])
    assert got["params"] <= tol(own["params"])
    for k, v in got["grads"].items():
        assert v <= tol(own["grads"][k], 1e-2), (k, v, own["grads"][k])
