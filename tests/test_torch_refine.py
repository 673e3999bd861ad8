"""The port's renderer and mode-3 refinement against the JAX package, on
the CPU in f32 at a small size, plus the import rule of the port.

* render_image and its pose gradient equal JAX's unfused render.
* A short refine_pose_single gives the loss curve and refined pose of
  JAX's unfused path, both with the port's unfused path (fused=False) and
  with its kernel paths: pre-embedded (fused_pre=True) with the
  composite-fused render (K1/K3/K4) or the field kernels (K1/K2), and
  raw-input (fused_pre=False) with the render (K5/K7/K8) or the field
  kernels (K5/K6); on the CPU they run the kernels' plain versions. Tolerance 2e-4: Adam's first steps divide each gradient by
  its own magnitude, so f32 summation-order noise in a small gradient
  component shows in the pose at that level, and the losses agree to it.
* Mode 3 recovers a perturbed pose on the analytic blob scene (the port
  of tests/test_refine.py::test_mode3_recovers_perturbed_pose).
"""

import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.data.synthetic import _BLOBS
from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
from nefes_tpu.refine.pose_opt import refine_pose_single as jrefine
from nefes_tpu.refine.pose_opt import render_feature_image as jrender_feat
from nefes_tpu.render.renderer import render_image as jrender_image
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.geometry import learn_pose, rotation_angle
from nefes_tpu_torch.geometry.transforms import WorldSetup
from nefes_tpu_torch.refine import (
    RefineConfig, refine_pose_single, refine_poses_batch,
    render_feature_image,
)
from nefes_tpu_torch.render.renderer import RenderConfig, render_image
from tests.torch_parity import close, configs, models, n, t

HWF = (10, 12, 11.0)
NEAR, FAR = 0.5, 4.0
WS = [1.0, 1.0, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    kw = dict(n_samples=16, n_importance=16, output_transient=False,
              test_time=True, perturb=False, remat=False)
    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    pert = learn_pose(t([0.02, -0.03, 0.01]), t([0.05, -0.04, 0.03]),
                      t(gt))[:3, :4].numpy()
    return (jmodel, variables, jcfg.render_config(**kw), tmodel,
            tcfg.render_config(**kw), gt, pert)


def test_render_image_and_pose_grad(setup):
    jmodel, variables, jrc, tmodel, trc, gt, _ = setup
    p = variables["params"]
    H, W, focal = HWF

    def jrender(pose):
        return jrender_image(jmodel.coarse_fn, jmodel.fine_fn, p, p, H, W,
                             focal, pose, NEAR, FAR, jrc)

    want = jrender(jnp.asarray(gt))
    pose = t(gt, True)
    got = render_image(tmodel.coarse_fn, tmodel.fine_fn, H, W, focal, pose,
                       NEAR, FAR, trc)
    for k in ("rgb", "feat", "depth", "acc"):
        close(got[k], want[k], 1e-4, 1e-5, k)
    chunked = render_image(tmodel.coarse_fn, tmodel.fine_fn, H, W, focal,
                           pose, NEAR, FAR, trc, block_rays=50)
    for k in ("rgb", "feat", "depth", "acc"):
        close(chunked[k], got[k], 1e-6, 1e-6, k)
    (got["rgb"].sum() + (got["feat"] ** 2).sum()).backward()
    def jscore(c):
        o = jrender(c)
        return jnp.sum(o["rgb"]) + jnp.sum(o["feat"] ** 2)

    jg = jax.grad(jscore)(jnp.asarray(gt))
    scale = float(np.abs(np.asarray(jg)).max())
    close(pose.grad / scale, np.asarray(jg) / scale, 1e-4, 1e-4)


KERNEL_PATHS = {
    "unfused": dict(fused=False),
    "fused_render": dict(fused=True, fused_pre=True, fused_need_dw=False,
                         fused_render=True),
    "fused_field": dict(fused=True, fused_pre=True, fused_need_dw=False,
                        fused_render=False),
    "render_raw": dict(fused=True, fused_pre=False, fused_need_dw=False,
                       fused_render=True),
    "fused_raw": dict(fused=True, fused_pre=False, fused_need_dw=False,
                      fused_render=False),
}


@pytest.fixture(scope="module")
def jax_refine(setup):
    """JAX's unfused mode-3 run: (target features, losses, refined)."""
    jmodel, variables, jrc, _, _, gt, pert = setup
    _, target = jrender_feat(jmodel, variables, jnp.asarray(gt),
                             jnp.zeros(10), HWF, NEAR, FAR, jrc)
    rcfg = JRefine(opt_iter=6, lr_r=0.0087, lr_t=0.01)
    refined, losses = jrefine(jmodel, variables, jnp.asarray(pert), target,
                              jnp.zeros(10), jnp.asarray(WS), HWF, NEAR,
                              FAR, jrc, rcfg)
    return np.asarray(target), np.asarray(losses), np.asarray(refined)


@pytest.mark.parametrize("path", list(KERNEL_PATHS))
def test_refine_matches_jax(setup, jax_refine, path):
    _, _, _, tmodel, trc, gt, pert = setup
    target, jlosses, jrefined = jax_refine
    cfg = replace(trc, **KERNEL_PATHS[path])
    with torch.no_grad():
        _, ttarget = render_feature_image(tmodel, t(gt), torch.zeros(10),
                                          HWF, NEAR, FAR, cfg)
    close(ttarget, target, 1e-4, 1e-5, "target features")
    refined, losses = refine_pose_single(
        tmodel, t(pert), ttarget, torch.zeros(10), t(WS), HWF, NEAR, FAR,
        cfg, RefineConfig(opt_iter=6, lr_r=0.0087, lr_t=0.01))
    assert losses.shape == (6,) and float(losses[-1]) < float(losses[0])
    close(losses, jlosses, 2e-4, 2e-4, "losses")
    close(refined, jrefined, 2e-4, 2e-4, "refined pose")


# --- perturbed-pose recovery on the analytic scene ---

class AnalyticModel:
    """Duck-typed NeFeSModel whose field is the analytic blob scene of
    nefes_tpu/data/synthetic.py:blob_field (no texture)."""

    blobs = torch.from_numpy(_BLOBS)

    def coarse_fn(self, xyz_emb, dir_emb=None, sigma_only=False,
                  output_transient=False):
        xyz = xyz_emb[..., :3]
        d = torch.linalg.norm(xyz[..., None, :] - self.blobs[:, :3], dim=-1)
        occ = torch.sigmoid((self.blobs[:, 3] - d) * 40.0)
        out = {"static_sigma": 200.0 * occ.max(-1).values}
        if sigma_only:
            return out
        w = occ / torch.clamp_min(occ.sum(-1, keepdim=True), 1e-6)
        out["static_rgb"] = (w[..., None] * self.blobs[:, 4:7]).sum(-2)
        out["static_feat"] = torch.cat(
            [torch.sin(xyz * 3.0), torch.sin(xyz * 9.0 + 0.5),
             occ.max(-1, keepdim=True).values,
             d.min(-1, keepdim=True).values], dim=-1)
        return out

    fine_fn = coarse_fn

    def apply_exposure(self, hist, rgb):
        return torch.sigmoid(rgb)

    def apply_fusion(self, rgb_img, feat_img, bn_stats="batch"):
        return feat_img


BLOB_CFG = RenderConfig(n_samples=48, n_importance=24, perturb=False,
                        output_transient=False, test_time=True,
                        xyz_embed=EmbedConfig(num_freqs=1),
                        dir_embed=EmbedConfig(num_freqs=1))
BLOB_HWF = (20, 24, 22.0)


def _pose_err(a, b):
    tr = float(torch.linalg.norm(a[:3, 3] - b[:3, 3]))
    rot = float(rotation_angle(a[:3, :3] @ b[:3, :3].T))
    return tr, rot


def test_mode3_recovers_perturbed_pose():
    model = AnalyticModel()
    gt = t(look_at_pose(np.array([0.0, 0.3, 2.4], np.float32)))
    rng = np.random.default_rng(0)
    dr = rng.normal(0, 0.03, 3).astype(np.float32)   # ~2 deg
    dt = rng.normal(0, 0.05, 3).astype(np.float32)   # 5 cm
    pert = learn_pose(t(dr), t(dt), gt)[:3, :4]
    hist = torch.zeros(10)
    with torch.no_grad():
        _, target = render_feature_image(model, gt, hist, BLOB_HWF, 0.5, 5.0,
                                         BLOB_CFG)
    rcfg = RefineConfig(opt_iter=50, lr_r=0.001, lr_t=0.001, per_pixel=True)
    t0, r0 = _pose_err(pert, gt)
    refined, losses = refine_pose_single(model, pert, target, hist, t(WS),
                                         BLOB_HWF, 0.5, 5.0, BLOB_CFG, rcfg)
    t1, r1 = _pose_err(refined, gt)
    assert np.isfinite(n(losses)).all()
    assert float(losses[-1]) < float(losses[0])
    assert t1 < t0, (t0, t1)
    assert r1 < 0.6 * r0, (r0, r1)

    ws = WorldSetup(near=0.5, far=5.0, pose_scale=1.0, pose_scale2=1.0,
                    move_all_cam_vec=(0.0, 0.0, 0.0))
    poses, batch_losses = refine_poses_batch(
        model, torch.stack([pert, pert]), torch.stack([target, target]),
        torch.zeros(2, 10), ws, BLOB_HWF, BLOB_CFG,
        replace(rcfg, opt_iter=3))
    assert poses.shape == (2, 3, 4) and batch_losses.shape == (2, 3)
    close(batch_losses[0], losses[:3], 1e-6, 1e-6)


# --- the port imports no JAX ---

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|nefes_tpu)(\.|\s|$)"
    r"|__import__\(\s*['\"](jax|flax|optax|orbax|nefes_tpu)['\".]"
    r"|import_module\(\s*['\"](jax|flax|optax|orbax|nefes_tpu)['\".]",
    re.M)


_SERVING_MODULES = (
    "cli/options.py", "cli/train.py", "cli/refine.py", "cli/evaluate.py",
    "data/images.py", "data/seven_scenes.py", "data/cambridge.py",
    "evaluation/metrics.py", "evaluation/ate.py", "evaluation/golden.py",
    "features/convert.py", "refine/graph.py", "geometry/transforms.py",
    "refine/pose_opt.py", "features/backbones.py", "features/posenet.py",
    "features/mstransformer.py", "features/apr_loader.py",
    "features/convert_backbones.py", "weights.py", "runtime/probe.py",
    "runtime/accuracy.py", "runtime/xprof.py", "native/__init__.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/train_dp.py",
    "refine/legacy_train.py", "utils/homography.py", "utils/colmap.py",
    "utils/kalman.py", "data/llff_blender.py", "data/augment.py",
    "data/multiframe.py", "data/setup_7scenes.py",
    "data/setup_cambridge.py")


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "nefes_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    names = {str(f.relative_to(root)) for f in files}
    for module in ("features/dfnet.py", "refine/apr_opt.py", "utils/image.py",
                   "utils/ssim.py", "train/losses.py", "train/trainer.py",
                   "train/checkpoint.py", "data/histograms.py",
                   "data/scene.py", "data/synthetic.py", *_SERVING_MODULES):
        assert f"nefes_tpu_torch/{module}" in names, module
    assert len(files) > 25
    hits = [f"{f.relative_to(root)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    # importing every serving module (and chip_smoke) loads neither JAX
    # nor the JAX package, in a process that had neither
    mods = ["nefes_tpu_torch." + m[:-3].replace("/", ".").removesuffix(
        ".__init__") for m in _SERVING_MODULES] + ["chip_smoke"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nefes_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
