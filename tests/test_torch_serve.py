"""The port's serving stack against the JAX package, on the CPU in f32:
image reading, the 7-Scenes and Cambridge loaders, evaluation, reference
checkpoint conversion and the four serving functions.

* data/images.py and the depth readers equal the JAX loaders' PIL + cv2
  route (the same libraries, on the machine with the card too).
* The loaders on make_7scenes_fixture (df 8) and on a Cambridge layout
  written here: poses to 1e-9, images, histograms, masks, hwf, near / far
  and the centring stats equal, against both of the JAX loaders' image
  routes (its native reader and PIL).
* Evaluation: errors, summaries, accuracy buckets, the pose txt round
  trip, ATE and the golden-file harness to 1e-9.
* Conversion: the reference .tar and DFNet state dict give, tensor for
  tensor, what the JAX converters carried into the port give.
* The serving functions on the CPU run the eager loop: mode 3 to the
  mode-3 tests' 2e-4, mode 2 to the mode-2 tests' 1e-5 relative, pose
  5e-6. The captured loop's parts that run here: the polar iteration
  against the SVD, GraphAdam against torch's Adam. On the card (marked
  cuda), the captured loop against the eager one.
"""

import copy
import json
import os
import os.path as osp
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixture_datasets import make_7scenes_fixture
from tests.torch_parity import close, configs, models, n, t

RNG = np.random.default_rng(7)


# --- data/images.py against the JAX loaders' PIL route ---

@pytest.mark.parametrize("src,df", [((480, 640), 2.0), ((480, 640), 8.0),
                                    ((480, 854), 2.0), ((60, 80), 1.0)],
                         ids=["7scenes_df2", "7scenes_df8", "cambridge_df2",
                              "df1"])
def test_load_images_matches_jax(tmp_path, monkeypatch, src, df):
    from PIL import Image
    from nefes_tpu.data.seven_scenes import _load_images
    from nefes_tpu_torch.data.images import load_images
    monkeypatch.setenv("NEFES_NATIVE_LOADER", "0")
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(RNG.integers(0, 256, src + (3,)).astype(
            np.uint8)).save(paths[-1])
    h, w = int(src[0] // df), int(src[1] // df)
    got = load_images(paths, df, h, w)
    assert got.dtype == np.float32 and got.shape == (2, h, w, 3)
    assert np.array_equal(got, _load_images(paths, df, h, w))


def test_depth_readers_match_jax(tmp_path):
    from PIL import Image
    from nefes_tpu.data.cambridge import load_dpt_depth as jdpt
    from nefes_tpu.data.seven_scenes import load_depth_png as jkinect
    from nefes_tpu_torch.data.cambridge import load_dpt_depth
    from nefes_tpu_torch.data.seven_scenes import load_depth_png
    d = RNG.integers(0, 65536, (48, 64)).astype(np.uint16)
    d[::7, ::5] = 65535                               # invalid Kinect depth
    path = str(tmp_path / "d.png")
    Image.fromarray(d).save(path)
    assert np.array_equal(load_depth_png(path, 24, 32, 2.0),
                          jkinect(path, 24, 32, 2.0))
    assert np.array_equal(load_dpt_depth(path, 24, 32), jdpt(path, 24, 32))


# --- the loaders ---

@pytest.fixture(scope="module")
def fixture_7scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seven"))
    return make_7scenes_fixture(root)


def _same_scene(got, want):
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.raw_poses, want.raw_poses, rtol=0,
                               atol=1e-9)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.hists, want.hists)
    assert got.hwf == want.hwf
    assert (got.near, got.far) == (want.near, want.far)
    assert got.world == type(got.world)(**want.world.__dict__)
    assert np.array_equal(got.pose_avg_stats, want.pose_avg_stats)
    assert got.image_paths == want.image_paths


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("loader", ["dslam", "colmap"])
@pytest.mark.parametrize("split", ["train", "test_centred_by_train"])
def test_7scenes_loaders_match_jax(fixture_7scenes, monkeypatch, route,
                                   loader, split):
    from nefes_tpu import data as jdata
    from nefes_tpu_torch import data as tdata
    monkeypatch.setenv("NEFES_NATIVE_LOADER", "1" if route == "native"
                       else "0")
    name = {"dslam": "load_7scenes_dslam", "colmap": "load_7scenes_colmap"}
    jload, tload = getattr(jdata, name[loader]), getattr(tdata, name[loader])
    args = ("chess", osp.dirname(fixture_7scenes["datadir"]),
            fixture_7scenes["data_root"])
    kw = dict(df=8.0)
    if split == "train":
        want, got = jload(*args, train=True, **kw), tload(*args, train=True,
                                                          **kw)
    else:
        stats = tload(*args, train=True, load_pose_avg_stats=False,
                      **kw).pose_avg_stats
        jstats = jload(*args, train=True, load_pose_avg_stats=False,
                       **kw).pose_avg_stats
        assert np.array_equal(stats, jstats)
        want = jload(*args, train=False, pose_avg_override=jstats, **kw)
        got = tload(*args, train=False, pose_avg_override=stats, **kw)
    assert got.images.shape == (4, 60, 80, 3)
    _same_scene(got, want)


def _write_cambridge(root, rng, n_train=3, n_test=2, hw=(120, 213)):
    """<root>/Shop/{train,test}/{rgb,poses,semantic}/ at the loader's df 4
    size (no resize), world_setup.json and pose_avg_stats.txt."""
    from PIL import Image
    scene = osp.join(root, "Shop")
    for split, cnt in (("train", n_train), ("test", n_test)):
        for sub in ("rgb", "poses", "semantic"):
            os.makedirs(osp.join(scene, split, sub), exist_ok=True)
        for i in range(cnt):
            img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            Image.fromarray(img).save(osp.join(scene, split, "rgb",
                                               f"f{i:03d}.png"))
            sem = rng.integers(0, 256, hw).astype(np.uint8)
            Image.fromarray(sem).save(osp.join(scene, split, "semantic",
                                               f"f{i:03d}.png"))
            c2w = np.eye(4)
            a = 0.2 * i + (0.5 if split == "test" else 0.0)
            c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
            c2w[:3, 3] = [3.0 * i, 0.5, -2.0 + i]
            np.savetxt(osp.join(scene, split, "poses", f"f{i:03d}.txt"), c2w)
    with open(osp.join(scene, "world_setup.json"), "w") as f:
        json.dump({"near": 0.0, "far": 10.0, "pose_scale": 0.3,
                   "pose_scale2": 0.5, "move_all_cam_vec": [0.1, 0.0, 1.0]},
                  f)
    pa = np.eye(4)[:3]
    pa[:, 3] = [0.5, 0.1, -0.3]
    np.savetxt(osp.join(scene, "pose_avg_stats.txt"), pa)
    return scene


@pytest.mark.parametrize("split", [True, False], ids=["train", "test"])
def test_cambridge_loader_matches_jax(tmp_path, monkeypatch, split):
    from nefes_tpu.data import load_cambridge as jload
    from nefes_tpu.data import load_semantic_mask as jmask
    from nefes_tpu_torch.data import load_cambridge as tload
    from nefes_tpu_torch.data import load_semantic_mask as tmask
    monkeypatch.setenv("NEFES_NATIVE_LOADER", "0")
    scene = _write_cambridge(str(tmp_path), np.random.default_rng(3))
    kw = dict(train=split, df=4.0, semantic=True, tinyscale=4.0)
    want = jload("Shop", str(tmp_path), **kw)
    got = tload("Shop", str(tmp_path), **kw)
    _same_scene(got, want)
    assert got.masks.shape == want.masks.shape == (len(got), 30, 53)
    assert np.array_equal(got.masks, want.masks)
    path = osp.join(scene, "test", "semantic", "f000.png")
    for erosion in (True, False):
        assert np.array_equal(tmask(path, 40, 71, erosion),
                              jmask(path, 40, 71, erosion))


# --- evaluation ---

def _noisy_poses(k, scale=0.05):
    rot = np.linalg.qr(RNG.normal(size=(k, 3, 3)))[0]
    pose = np.concatenate([rot, RNG.normal(size=(k, 3, 1))], axis=2)
    return pose, pose + RNG.normal(0, scale, pose.shape)


def test_metrics_match_jax(tmp_path):
    from nefes_tpu import evaluation as J
    from nefes_tpu_torch import evaluation as T
    gt, pred = _noisy_poses(40)
    for a, b in ((pred, gt), (pred.reshape(40, 12), gt.reshape(40, 12))):
        np.testing.assert_allclose(T.pose_errors(a, b), J.pose_errors(a, b),
                                   rtol=0, atol=1e-9)
    errs = J.pose_errors(pred, gt)
    np.testing.assert_allclose(T.rotation_angle_np(pred[:, :, :3]),
                               J.rotation_angle_np(pred[:, :, :3]), rtol=0,
                               atol=1e-9)
    assert T.accuracy_stats(errs) == J.accuracy_stats(errs)
    assert T.summarize(errs) == J.summarize(errs)
    assert T.ACCURACY_BUCKETS == J.ACCURACY_BUCKETS
    tp, jp = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    T.save_pose_txt(tp, pred)
    J.save_pose_txt(jp, pred)
    with open(tp) as f, open(jp) as g:
        assert f.read() == g.read()
    assert np.array_equal(T.load_pose_txt(tp), J.load_pose_txt(jp))


def test_ate_matches_jax():
    from nefes_tpu.evaluation import ate as J
    from nefes_tpu_torch.evaluation import ate as T
    gt, _ = _noisy_poses(30)
    R = np.linalg.qr(RNG.normal(size=(3, 3)))[0]
    moved = gt.copy()
    moved[:, :, :3] = R @ gt[:, :, :3]
    moved[:, :, 3] = 1.7 * gt[:, :, 3] @ R.T + [0.3, -0.2, 1.0]
    moved = moved + RNG.normal(0, 1e-3, moved.shape)
    for with_scale in (True, False):
        for a, b in zip(T.umeyama_alignment(gt[:, :, 3], moved[:, :, 3],
                                            with_scale),
                        J.umeyama_alignment(gt[:, :, 3], moved[:, :, 3],
                                            with_scale)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    np.testing.assert_allclose(T.align_ate_c2b_use_a2b(gt, moved),
                               J.align_ate_c2b_use_a2b(gt, moved), rtol=0,
                               atol=1e-9)
    for fn in ("compute_ate_error", "compute_none_ate_error"):
        got, want = getattr(T, fn)(gt, moved), getattr(J, fn)(gt, moved)
        assert got.keys() == want.keys()
        for k in got:
            if k != "accuracy":
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-9)
        assert got["accuracy"] == want["accuracy"]


def _write_paper_result(root):
    """A paper_result-shaped tree: every scene of both datasets, 5 frames
    of GT, initial and refined poses."""
    from nefes_tpu.evaluation import (
        CAMBRIDGE_SCENES, SEVEN_SCENES, paper_result_dir, save_pose_txt,
    )
    for ds, scenes in (("7Scenes_colmap", SEVEN_SCENES),
                       ("Cambridge", CAMBRIDGE_SCENES)):
        for scene in scenes:
            d = paper_result_dir(root, ds) / scene
            d.mkdir(parents=True)
            gt, apr = _noisy_poses(5, 0.1)
            refined = gt + (apr - gt) * 0.3
            save_pose_txt(d / f"{scene}_test_gt.txt", gt)
            save_pose_txt(d / f"DFNet_{scene}_results.txt", apr)
            save_pose_txt(d / f"DFNet_{scene}_NeFeS50_APR_pose_results.txt",
                          refined)


def test_golden_matches_jax(tmp_path):
    from nefes_tpu import evaluation as J
    from nefes_tpu_torch import evaluation as T
    _write_paper_result(tmp_path)
    want, got = J.evaluate_all(tmp_path), T.evaluate_all(tmp_path)
    assert got.keys() == want.keys() and len(got) == 22
    for k in got:
        assert got[k] == want[k], k
    base = T.paper_result_dir(tmp_path, "Cambridge")
    assert (T.evaluate_scene(base / "ShopFacade", "ShopFacade", False)
            == J.evaluate_scene(base / "ShopFacade", "ShopFacade", False))
    assert T.SEVEN_SCENES == J.SEVEN_SCENES
    assert T.CAMBRIDGE_SCENES == J.CAMBRIDGE_SCENES


# --- conversion ---

def test_convert_nefes_checkpoint_matches_jax(tmp_path):
    from nefes_tpu.features.convert import convert_nefes_checkpoint as jconv
    from nefes_tpu_torch.features.convert import convert_nefes_checkpoint
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    from nefes_tpu_torch.weights import from_jax_variables
    from tests.test_nefes_tar import build_reference_tar
    path = str(tmp_path / "600.tar")
    build_reference_tar(path, np.random.default_rng(0), depth=8, width=64,
                        fdim=16)
    cfg = ModelConfig(width=64, feature_dim=16)
    want = from_jax_variables(jax.tree.map(np.asarray, jconv(path, depth=8)),
                              cfg)
    got = convert_nefes_checkpoint(path, depth=8)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    NeFeSModel(cfg, device="cpu").load_state_dict(got)    # strict


def test_convert_dfnet_matches_jax(tmp_path):
    from nefes_tpu.features.convert import convert_dfnet as jconv
    from nefes_tpu.features.convert import load_torch_state_dict as jload
    from nefes_tpu_torch.features import DFNet
    from nefes_tpu_torch.features.convert import (
        convert_dfnet, load_torch_state_dict,
    )
    from nefes_tpu_torch.weights import dfnet_from_jax_variables
    from tests.test_dfnet_convert import build_torch_dfnet_replica
    torch.manual_seed(0)
    path = str(tmp_path / "dfnet.pt")
    torch.save({"state_dict": build_torch_dfnet_replica().state_dict()},
               path)
    want = dfnet_from_jax_variables(jconv(jload(path)))
    got = convert_dfnet(load_torch_state_dict(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    DFNet(device="cpu").load_state_dict(got)               # strict


def test_convert_exposure_mlp_matches_jax():
    from nefes_tpu.features.convert import convert_exposure_mlp as jconv
    from nefes_tpu_torch.features.convert import convert_exposure_mlp
    packed = RNG.normal(0, 0.1, 32 * 16 + 32 * 32 * 2 + 16 * 32).astype(
        np.float32)
    want = jconv(packed)
    got = convert_exposure_mlp(torch.from_numpy(packed))
    for name, leaf in want.items():
        assert np.array_equal(got[f"{name}.weight"].numpy(), leaf["kernel"].T)
        assert np.array_equal(got[f"{name}.bias"].numpy(), leaf["bias"])
    with pytest.raises(ValueError):
        convert_exposure_mlp(torch.zeros(10))


# --- the serving functions (eager on the CPU) ---

HWF = (10, 12, 11.0)
NEAR, FAR = 0.5, 4.0
WS = [1.0, 1.0, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def tiny():
    from nefes_tpu.refine.pose_opt import render_feature_image as jrender
    from nefes_tpu_torch.data.synthetic import look_at_pose
    from nefes_tpu_torch.geometry import learn_pose
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    kw = dict(n_samples=16, n_importance=16, output_transient=False,
              test_time=True, perturb=False, remat=False)
    jrc, trc = jcfg.render_config(**kw), tcfg.render_config(**kw)
    gt = look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))
    inits, targets = [], []
    for i, (dr, dt) in enumerate((([0.02, -0.03, 0.01], [0.05, -0.04, 0.03]),
                                  ([-0.01, 0.02, 0.02], [-0.03, 0.05, 0.0]))):
        inits.append(learn_pose(t(dr), t(dt), t(gt))[:3, :4].numpy())
        _, f = jrender(jmodel, variables, jnp.asarray(gt), jnp.zeros(10),
                       HWF, NEAR, FAR, jrc)
        targets.append(np.asarray(f))
    return (jmodel, variables, jrc, tmodel, trc, np.stack(inits),
            np.stack(targets))


def test_refine_pose_serving_matches_jax(tiny):
    from nefes_tpu.geometry.transforms import WorldSetup as JWS
    from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
    from nefes_tpu.refine.pose_opt import (
        refine_pose_indexed as jindexed, refine_poses_scanned as jscanned,
    )
    from nefes_tpu_torch.geometry.transforms import WorldSetup
    from nefes_tpu_torch.refine import (
        RefineConfig, refine_pose_indexed, refine_poses_scanned,
    )
    jmodel, variables, jrc, tmodel, trc, inits, targets = tiny
    hists = np.zeros((2, 10), np.float32)
    ws = dict(near=NEAR, far=FAR, pose_scale=1.0, pose_scale2=1.0,
              move_all_cam_vec=(0.0, 0.0, 0.0))
    jr, rc = (JRefine(opt_iter=4, lr_r=0.0087, lr_t=0.01),
              RefineConfig(opt_iter=4, lr_r=0.0087, lr_t=0.01))
    want_scan = np.asarray(jscanned(jmodel, variables, jnp.asarray(inits),
                                    jnp.asarray(targets), jnp.asarray(hists),
                                    JWS(**ws), HWF, jrc, jr))
    want_one = np.asarray(jindexed(jmodel, variables, jnp.asarray(inits),
                                   jnp.asarray(targets), jnp.asarray(hists),
                                   1, jnp.asarray(WS), HWF, NEAR, FAR, jrc,
                                   jr))
    cfg = replace(trc, fused=True, fused_pre=True, fused_render=True,
                  fused_need_dw=False)
    got_scan = refine_poses_scanned(tmodel, t(inits), t(targets), t(hists),
                                    WorldSetup(**ws), HWF, cfg, rc)
    got_one = refine_pose_indexed(tmodel, t(inits), t(targets), t(hists), 1,
                                  t(WS), HWF, NEAR, FAR, cfg, rc)
    assert got_scan.shape == (2, 3, 4)
    close(got_scan, want_scan, 2e-4, 2e-4, "scanned")
    close(got_one, want_one, 2e-4, 2e-4, "indexed")
    close(got_one, got_scan[1], 0, 0, "indexed is a frame of scanned")
    assert np.abs(want_one - inits[1]).max() > 1e-3     # the pose moved


@pytest.fixture(scope="module")
def tiny_apr(tiny):
    """The JAX DFNet with random BN statistics, its fc_pose aimed at the
    scene, carried into the port; two 32×48 queries and their targets."""
    from nefes_tpu.features.dfnet import DFNet as JDFNet
    from nefes_tpu.features.dfnet import extract_target_features as jextract
    from nefes_tpu_torch.features import DFNet
    from nefes_tpu_torch.weights import dfnet_from_jax_variables
    inits = tiny[5]
    images = RNG.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    jd = JDFNet(output_dim=8)
    v = jax.tree.map(np.asarray, jd.init(jax.random.key(0), images[:1]))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    for blk in v["batch_stats"].values():
        blk["bn"]["mean"] = RNG.normal(0, 0.1, blk["bn"]["mean"].shape)
        blk["bn"]["var"] = RNG.uniform(0.5, 1.5, blk["bn"]["var"].shape)
    v["params"]["fc_pose"]["kernel"] = v["params"]["fc_pose"]["kernel"] * 0.05
    v["params"]["fc_pose"]["bias"] = inits[0].reshape(12)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), v)
    td = DFNet(output_dim=8, device="cpu")
    td.load_state_dict(dfnet_from_jax_variables(v))
    jv = jax.tree.map(jnp.asarray, v)
    targets = np.asarray(jextract(jd, jv, jnp.asarray(images), 32, 48))
    return jd, jv, td, images, targets


def test_refine_apr_serving_matches_jax(tiny, tiny_apr):
    """One JAX scan over frames [1, 0] (histograms [0, 1]); the port's
    scanned and verified serving functions against its rows."""
    from nefes_tpu.refine.apr_opt import (
        refine_apr_verified_scanned as jscanned,
    )
    from nefes_tpu.refine.pose_opt import RefineConfig as JRefine
    from nefes_tpu_torch.refine import (
        RefineConfig, refine_apr_verified, refine_apr_verified_scanned,
    )
    jmodel, variables, jrc, tmodel, trc = tiny[:5]
    jd, jv, td, images, targets = tiny_apr
    hists = np.stack([np.zeros(10), np.full(10, 10.0)]).astype(np.float32)
    hwf_full, hwf_render = (32, 48, 22.0), (8, 12, 5.5)
    common = dict(svd_reg=True, use_verification=True,
                  verification_metric="dfm")
    want = np.asarray(jscanned(
        jmodel, variables, jd, jv, jnp.asarray(images), jnp.asarray(targets),
        jnp.asarray(hists), jnp.asarray([1, 0]), jnp.asarray([0, 1]),
        jnp.asarray(WS), hwf_render, hwf_full, NEAR, FAR, jrc,
        JRefine(opt_iter=3, learning_rate=1e-5), **common))
    cfg = replace(trc, fused=True, fused_pre=False, fused_render=True,
                  fused_need_dw=False)
    args = (t(WS), hwf_render, hwf_full, NEAR, FAR, cfg,
            RefineConfig(opt_iter=3, learning_rate=1e-5))
    got = refine_apr_verified_scanned(tmodel, td, t(images), t(targets),
                                      t(hists), [1, 0], [0, 1], *args,
                                      **common)
    one = refine_apr_verified(tmodel, td, t(images), t(targets), t(hists), 0,
                              1, *args, **common)
    assert got.shape == (2, 3, 4)
    close(got, want, 0, 5e-6, "scanned")
    close(one, want[1], 0, 5e-6, "verified")


@pytest.mark.parametrize("scale", [0.05, 0.3, 1.0, 3.0])
def test_polar_orthogonalisation_matches_svd(scale):
    """The captured loop's svd_reg (the polar iteration) against the SVD:
    values and the gradient of a weighted sum, in f64 to 1e-12 of their
    scale (matrices near a rotation and far from one, condition numbers
    up to ~4e3) and in f32 to 2e-5."""
    from nefes_tpu_torch.geometry.se3 import (
        orthogonalize_rotation, orthogonalize_rotation_polar,
    )
    rng = np.random.default_rng(int(scale * 100))
    pose = rng.normal(0, 1, (64, 3, 4))
    pose[:, :, :3] = pose[:, :, :3] * scale + np.eye(3) * (scale < 3)
    w = rng.normal(0, 1, (64, 3, 4))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        outs = []
        for fn in (orthogonalize_rotation, orthogonalize_rotation_polar):
            x = torch.tensor(pose, dtype=dtype, requires_grad=True)
            out = fn(x)
            (out * torch.tensor(w, dtype=dtype)).sum().backward()
            outs.append((out.detach(), x.grad))
        (va, ga), (vb, gb) = outs
        assert (va - vb).abs().max() <= tol
        assert (ga - gb).abs().max() <= tol * ga.abs().max()


def test_graph_adam_matches_torch_adam():
    """GraphAdam against torch.optim.Adam(foreach=True), two groups, a
    parameter without gradients, 20 steps. On the CPU the foreach ops run
    per tensor and addcdiv associates differently, so 1e-6 relative; on
    the card the captured loops are held to the eager ones bit for bit
    (chip_smoke.py's mode3 and mode2 phases)."""
    from nefes_tpu_torch.refine.graph import GraphAdam
    gen = torch.Generator().manual_seed(0)
    ps = [torch.randn(7, 5, generator=gen), torch.randn(3, generator=gen),
          torch.randn(4, generator=gen)]
    qs = [p.clone() for p in ps]
    opt = torch.optim.Adam([{"params": [ps[0], ps[2]], "lr": 0.01},
                            {"params": [ps[1]], "lr": 0.1}],
                           betas=(0.9, 0.999), eps=1e-8, foreach=True)
    gadam = GraphAdam([([qs[0], qs[2]], 0.01), ([qs[1]], 0.1)], 20)
    for k in range(20):
        for p, q in zip(ps[:2], qs[:2]):
            g = torch.randn(p.shape, generator=gen) * 10.0 ** (-(k % 5))
            p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        gadam.step(torch.tensor([k]))
        for p, q in zip(ps, qs):
            close(q, p, 1e-6, 1e-7, f"step {k}")
    assert torch.equal(qs[2], ps[2])          # no gradient: not moved
    gadam.zero_()
    assert all(not m.any() and not v.any() for m, v in gadam.moments.values())


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_matches_eager_on_card(cuda, tiny, tiny_apr):
    """The captured loops against the eager ones at the tiny size on the
    card, through the kernel paths: mode-3 losses and pose to 2e-4, mode 2
    to 1e-5 relative and the pose to 5e-6 (capturable Adam's bias
    correction on the device, the polar orthogonalisation for the SVD)."""
    from nefes_tpu_torch.refine import (
        RefineConfig, refine_apr_captured, refine_apr_single,
        refine_pose_captured, refine_pose_single,
    )
    tmodel, trc, inits, targets = tiny[3], tiny[4], tiny[5], tiny[6]
    _, _, td, images, atargets = tiny_apr
    model = copy.deepcopy(tmodel).to(cuda)
    apr = copy.deepcopy(td).to(cuda)
    cfg = replace(trc, fused=True, fused_pre=True, fused_render=True,
                  fused_need_dw=False)
    args = (model, t(inits[0]).to(cuda), t(targets[0]).to(cuda),
            torch.zeros(10, device=cuda), t(WS).to(cuda), HWF, NEAR, FAR,
            cfg, RefineConfig(opt_iter=4, lr_r=0.0087, lr_t=0.01))
    pe, le = refine_pose_single(*args)
    for _ in range(2):                       # capture, then replay only
        pc, lc = refine_pose_captured(*args)
        close(lc.cpu(), le.cpu(), 2e-4, 2e-4, "mode-3 losses")
        close(pc.cpu(), pe.cpu(), 2e-4, 2e-4, "mode-3 pose")
    cfg2 = replace(cfg, fused_pre=False)
    args2 = (model, apr, t(images[0]).to(cuda), t(atargets[0]).to(cuda),
             torch.zeros(10, device=cuda), t(WS).to(cuda), (8, 12, 5.5),
             (32, 48, 22.0), NEAR, FAR, cfg2,
             RefineConfig(opt_iter=3, learning_rate=1e-5))
    want = refine_apr_single(*args2)
    for _ in range(2):
        got = refine_apr_captured(*args2)
        for k in ("losses", "init_psnr", "end_psnr", "init_ssim",
                  "end_ssim"):
            close(got[k].cpu(), want[k].cpu(), 1e-5, 1e-6, k)
        for k in ("refined_pose", "initial_pose"):
            close(got[k].cpu(), want[k].cpu(), 0, 5e-6, k)
