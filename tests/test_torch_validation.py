"""The port's validation renders and training utilities against the JAX
package's, on the CPU in f32 at a tiny size (the kernel wrappers run
their plain versions).

1. render_test on the same field and DFNet weights (depth 2, width 32,
   8 features; 48×64 views rendered at tinyscale 4, 8 + 8 samples,
   transient heads on as the CLI renders them): with DFNet's features
   past EPOCH_TO_FUSION (FusionNet on batch statistics) and the videos,
   and without (full-resolution renders; also upsampled, as the 1080p
   renderer does). The port renders through the
   frozen K5 (its plain version), JAX through its plain fields. PSNR and
   the feature cosine loss within 1e-4 relative, every frame within
   1e-4, the same files written.
2. generate_render_pose with the same numpy generator to 1e-9; the rest
   of view_selection (frustum overlap, unique and nearest views) equal.
3. fusion_pre_bn and calibrate_fusion_bn (the BN's new scale, bias and
   running statistics, and the fit statistics) to 1e-5 relative;
   fusion_conv_liveness's live units and EarlyStopping equal.
4. viz's saliency grid and frustum PLY equal; video round trip; the
   profiling hooks write a Chrome trace and time phases.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.data import view_selection as jvs
from nefes_tpu.features.dfnet import DFNet as JDFNet
from nefes_tpu.render import validation as jval
from nefes_tpu.train import calibration as jcal
from nefes_tpu.train.callbacks import EarlyStopping as JEarlyStopping
from nefes_tpu.train.diagnostics import fusion_conv_liveness as jliveness
from nefes_tpu.utils import viz as jviz
from nefes_tpu_torch.data import view_selection as tvs
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.features.dfnet import DFNet
from nefes_tpu_torch.render import validation as tval
from nefes_tpu_torch.train import calibration as tcal
from nefes_tpu_torch.train.callbacks import EarlyStopping
from nefes_tpu_torch.train.diagnostics import fusion_conv_liveness
from nefes_tpu_torch.utils import profiling, video, viz
from nefes_tpu_torch.weights import dfnet_from_jax_variables
from tests.torch_parity import close, configs, models, replace, t

RNG = np.random.default_rng(21)
HH, WW, FOCAL, NEAR, FAR = 48, 64, 60.0, 0.5, 4.0
F = 8


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def field():
    jcfg, tcfg = configs(feature_dim=F)
    jmodel, variables, tmodel = models(jcfg, tcfg, seed=3)
    tmodel.requires_grad_(False)
    jd = JDFNet(output_dim=F)
    dv = jd.init(jax.random.key(4), jnp.zeros((1, HH, WW, 3)),
                 upsample_hw=(HH, WW))
    dv = jax.tree.map(lambda x: np.asarray(x, np.float32), dv)
    td = DFNet(output_dim=F, device="cpu")
    td.load_state_dict(dfnet_from_jax_variables(dv))
    td.requires_grad_(False)
    return jcfg, tcfg, jmodel, variables, tmodel, (jd, dv), td


def _views(n_views):
    eyes = [(2.2 * np.sin(a), 0.3, 2.2 * np.cos(a))
            for a in np.linspace(0.0, 0.8, n_views)]
    return {"poses": np.stack([look_at_pose(np.array(e, np.float32))
                               for e in eyes]),
            "hists": RNG.uniform(0, 30, (n_views, 10)).round().astype(
                np.float32),
            "images": RNG.uniform(0, 1, (n_views, HH, WW, 3)).astype(
                np.float32)}


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("with_feature", [True, False],
                         ids=["feature", "full_res"])
def test_render_test_matches_jax(field, tmp_path, with_feature):
    jcfg, tcfg, jmodel, variables, tmodel, jdf, td = field
    kw = dict(n_samples=8, n_importance=8, perturb=False,
              output_transient=True)
    jrc = jcfg.render_config(**kw).test()
    trc = replace(tcfg.render_config(**kw).test(), fused=True,
                  fused_pre=False, fused_need_dw=False)
    train_v, val_v = _views(2), _views(1)
    step = 250 if with_feature else 100
    video_flags = (with_feature, with_feature)
    common = dict(hwf=(HH, WW, FOCAL), near=NEAR, far=FAR,
                  global_step=step, expname="exp", tinyscale=4.0,
                  with_feature=with_feature, render_video=video_flags)
    want = jval.render_test(jmodel, variables, train_v, val_v, cfg=jrc,
                            dfnet_bundle=jdf, basedir=str(tmp_path / "jax"),
                            **common)
    got = tval.render_test(tmodel, train_v, val_v, cfg=trc, dfnet=td,
                           basedir=str(tmp_path / "port"), **common)
    assert set(got) == set(want) == {"train", "val"}
    for split in want:
        keys = {k for k, v in want[split].items() if isinstance(v, float)}
        assert keys == {k for k, v in got[split].items()
                        if isinstance(v, float)}
        assert keys == ({"psnr", "feat_cos"} if with_feature else {"psnr"})
        for k in keys:
            assert got[split][k] == pytest.approx(want[split][k], rel=1e-4), k
        for k in ("frames_rgb", "frames_disp"):
            close(got[split][k], want[split][k], 0, 1e-4, f"{split} {k}")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    if not with_feature:
        # the 1080p renderer's path: full-resolution renders upsampled
        up = dict(hwf=(HH, WW, FOCAL), near=NEAR, far=FAR,
                  target_size=(80, 60))
        close(tval.render_path_upsample(tmodel, val_v["poses"],
                                        val_v["hists"], cfg=trc, **up),
              jval.render_path_upsample(jmodel, variables, val_v["poses"],
                                        val_v["hists"], cfg=jrc, **up),
              0, 1e-4, "upsampled")
    if with_feature:
        assert any(f.endswith("_feature.png")
                   for f in _files(tmp_path / "port"))
        frames = video.read_mp4(str(
            tmp_path / "port" / "exp" / "exp_trainset_000250_rgb.mp4"))
        assert frames.shape == (2, HH, WW, 3)


def test_generate_render_pose_and_view_selection_match_jax():
    poses = _views(6)["poses"].astype(np.float64)
    got = tvs.generate_render_pose(poses, (0.3, 4.0), n_views=7,
                                   rng=np.random.default_rng(4))
    want = jvs.generate_render_pose(poses, (0.3, 4.0), n_views=7,
                                    rng=np.random.default_rng(4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    K, fr, xr, yr = tvs.default_frustum_params()
    np.testing.assert_array_equal(
        tvs.frustum_overlap(poses[0], poses, fr, K, xr, yr),
        jvs.frustum_overlap(poses[0], poses, fr, K, xr, yr))
    uniq = tvs.fetch_unique_view_index(poses, 0.9)
    np.testing.assert_array_equal(uniq, jvs.fetch_unique_view_index(
        poses, 0.9))
    np.testing.assert_array_equal(
        tvs.select_nearest_neighbor_views(poses, 0.5, uniq, stride=1),
        jvs.select_nearest_neighbor_views(poses, 0.5, uniq, stride=1))


def test_calibration_matches_jax(field):
    _, _, jmodel, variables, tmodel, _, _ = field
    rgb = RNG.uniform(0, 1, (3, 10, 12, 3)).astype(np.float32)
    raw = RNG.normal(0, 1, (3, 10, 12, F)).astype(np.float32)
    pre = np.asarray(jcal.fusion_pre_bn(jmodel, variables, jnp.asarray(rgb),
                                        jnp.asarray(raw)))
    close(tcal.fusion_pre_bn(tmodel, t(rgb), t(raw)), pre, 1e-5,
          1e-5 * np.abs(pre).max())
    target = (pre * np.linspace(0.5, 2.0, F) + np.linspace(-1, 1, F)
              + RNG.normal(0, 0.3, pre.shape)).astype(np.float32)
    new_vars, want = jcal.calibrate_fusion_bn(
        jmodel, variables, jnp.asarray(rgb), jnp.asarray(raw),
        jnp.asarray(target))
    fused = tmodel.fusion.bn.state_dict()
    try:
        got = tcal.calibrate_fusion_bn(tmodel, t(rgb), t(raw), t(target))
        bn = tmodel.fusion.bn
        jbn = new_vars["params"]["fusion"]["bn"]
        jbs = new_vars["batch_stats"]["fusion"]["bn"]
        for mine, theirs in ((bn.weight, jbn["scale"]),
                             (bn.bias, jbn["bias"]),
                             (bn.running_mean, jbs["mean"]),
                             (bn.running_var, jbs["var"])):
            close(mine, theirs, 1e-5, 1e-5 * float(np.abs(theirs).max()))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    finally:
        tmodel.fusion.bn.load_state_dict(fused)


def test_liveness_and_early_stopping_match_jax(field, tmp_path):
    _, _, _, variables, tmodel, _, _ = field
    rgb = RNG.uniform(0, 1, (16, 20, 3)).astype(np.float32)
    feat = RNG.normal(0, 1, (16, 20, F)).astype(np.float32)
    got = fusion_conv_liveness(tmodel.fusion, t(rgb), t(feat))
    want = jliveness(variables["params"]["fusion"], jnp.asarray(rgb),
                     jnp.asarray(feat))
    # the same live units: JAX's share is an f32 mean, the port's exact
    units = 16 * 20 * 64
    assert {k: round(v * units) for k, v in got.items()} == {
        k: round(v * units) for k, v in want.items()}

    saved = {"jax": [], "port": []}
    stops = {
        "jax": JEarlyStopping(str(tmp_path / "j"), lambda p, s: saved[
            "jax"].append((os.path.relpath(p, tmp_path / "j"), s)),
            patience=2, delta=0.01),
        "port": EarlyStopping(str(tmp_path / "p"), lambda p, s: saved[
            "port"].append((os.path.relpath(p, tmp_path / "p"), s)),
            patience=2, delta=0.01)}
    for epoch, loss in enumerate((1.0, 0.9, 0.895, 0.7, 0.71, 0.72, 0.73)):
        for es in stops.values():
            es(loss, epoch, epoch=epoch, save_multiple=epoch % 2 == 0,
               save_all=epoch == 5)
        j, p = stops["jax"], stops["port"]
        assert (p.counter, p.best_score, p.early_stop, p.val_metric_min,
                p.is_best_model()) == (j.counter, j.best_score, j.early_stop,
                                       j.val_metric_min, j.is_best_model())
    assert saved["port"] == saved["jax"] and stops["port"].early_stop


def test_viz_video_and_profiling(tmp_path):
    feat = RNG.normal(0, 1, (9, 11, 8)).astype(np.float32)
    np.testing.assert_array_equal(viz.feature_saliency_grid(feat),
                                  jviz.feature_saliency_grid(feat))
    poses = _views(3)["poses"]
    viz.save_camera_frustums_ply(str(tmp_path / "p.ply"), poses)
    jviz.save_camera_frustums_ply(str(tmp_path / "j.ply"), poses)
    assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()
    frames = RNG.uniform(0, 1, (4, 16, 24, 3)).astype(np.float32)
    path = video.write_mp4(str(tmp_path / "v.mp4"), frames)
    back = video.read_mp4(path)
    assert back.shape == (4, 16, 24, 3) and back.dtype == np.uint8
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("work"):
            torch.ones(8).sum()
    assert timer.counts["work"] == 2 and "work:" in timer.report()
    assert profiling.end_timer_and_print(profiling.start_timer()) >= 0.0
