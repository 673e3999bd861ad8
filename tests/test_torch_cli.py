"""The port's refinement and evaluation CLIs against the JAX package's, on
the CPU in f32, end to end on make_7scenes_fixture (df 8: 60×80 queries,
15×20 renders) from the same reference .tar (depth 2, width 32, 128
features) and DFNet checkpoint, at opt_iter 2, lr_r 0.0087, lr_t 0.01,
8 + 8 samples; plus the Options parser.

* The pose txts agree to 2e-4 (the port runs its kernel paths' plain
  versions, JAX its unfused path). At a third iteration the mode-3 poses
  part by 1e-3 on this random field: Adam's second step divides each
  gradient by its first, and near-zero components of the pose gradient
  carry f32 noise.
* The summaries' medians agree to 1e-3 m and 0.05° (what 2e-4 on the
  poses allows).
* Both evaluate CLIs print the same lines for the same txts.
"""

import io
import os
import os.path as osp
from contextlib import redirect_stdout
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixture_datasets import make_7scenes_fixture
from tests.test_dfnet_convert import build_torch_dfnet_replica
from tests.test_nefes_tar import build_reference_tar


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """The fixture scene, a reference .tar and a DFNet checkpoint whose
    pose head starts near a test frame's pose."""
    root = str(tmp_path_factory.mktemp("cli"))
    paths = make_7scenes_fixture(root)
    tar = osp.join(root, "600.tar")
    build_reference_tar(tar, np.random.default_rng(0), depth=2, width=32,
                        fdim=128)
    torch.manual_seed(0)
    dfnet = build_torch_dfnet_replica()
    start = np.loadtxt(osp.join(paths["datadir"], "seq-02",
                                "frame-000001.pose.txt"))[:3].reshape(12)
    with torch.no_grad():
        dfnet.fc_pose.weight.mul_(0.01)
        dfnet.fc_pose.bias.copy_(torch.tensor(start, dtype=torch.float32))
    pt = osp.join(root, "dfnet.pt")
    torch.save(dfnet.state_dict(), pt)
    return paths, root, tar, pt


def _argv(fx, mode, out):
    paths, _, tar, pt = fx
    return ["--dataset_type", "7Scenes", "--datadir", paths["datadir"],
            "--data_root", paths["data_root"], "--df", "8",
            "--netdepth", "2", "--netwidth", "32", "--feature_dim", "128",
            "--N_samples", "8", "--N_importance", "8",
            "--pose_only", str(mode), "--opt_iter", "2", "--lr_r", "0.0087",
            "--lr_t", "0.01", "--ft_path", tar, "--pretrain_model_path", pt,
            "--field_compute_dtype", "float32", "--save_dir", out]


def _txt(out, n_iter=2):
    return osp.join(out, f"DFNet_chess_NeFeS{n_iter}_APR_pose_results.txt")


@pytest.mark.parametrize("mode", [3, 2])
def test_refine_cli_matches_jax(fx, mode):
    from nefes_tpu.cli.evaluate import main as jeval
    from nefes_tpu.cli.refine import main as jmain
    from nefes_tpu.evaluation import save_pose_txt
    from nefes_tpu_torch.cli.evaluate import main as teval
    from nefes_tpu_torch.cli.refine import main as tmain
    from nefes_tpu_torch.data import load_7scenes_dslam
    _, root, _, _ = fx
    jout, tout = osp.join(root, f"jax{mode}"), osp.join(root, f"port{mode}")
    want = jmain(_argv(fx, mode, jout))
    got = tmain(_argv(fx, mode, tout) + ["--device", "cpu"])
    jp, tp = np.loadtxt(_txt(jout)), np.loadtxt(_txt(tout))
    assert tp.shape == (4, 12) and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-4)
    assert got["n_frames"] == want["n_frames"] == 4
    assert abs(got["median_t_m"] - want["median_t_m"]) < 1e-3
    assert abs(got["median_r_deg"] - want["median_r_deg"]) < 0.05
    assert got["accuracy"] == want["accuracy"]

    # both evaluate CLIs on the same txts print the same lines
    paths = fx[0]
    test = load_7scenes_dslam("chess", osp.dirname(paths["datadir"]),
                              paths["data_root"], train=False, df=8.0)
    gt = osp.join(root, f"gt{mode}.txt")
    save_pose_txt(gt, test.poses)
    printed = []
    for ev in (jeval, teval):
        buf = io.StringIO()
        with redirect_stdout(buf):
            ev(["--pred", _txt(tout), "--gt", gt])
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] and "Median" in printed[0]
    s = teval(["--pred", _txt(tout), "--gt", gt])
    assert s == jeval(["--pred", _txt(tout), "--gt", gt])
    assert s["median_t_m"] == got["median_t_m"]


def test_refine_cli_refuses_what_is_not_ported(fx):
    from nefes_tpu_torch.cli.refine import main
    base = _argv(fx, 3, osp.join(fx[1], "refused")) + ["--device", "cpu"]
    for extra, err in ((["--apr_compute_dtype", "bfloat16"],
                        NotImplementedError),
                       (["--PoseEstimatorType", "NetVlad"],
                        NotImplementedError),
                       (["--tcnn", "true"], NotImplementedError),
                       (["--pose_only", "1"], ValueError)):
        with pytest.raises(err):
            main(base + extra)


@pytest.mark.parametrize("df", [2, 4])
def test_nearest_upsample_matches_jax(df):
    """The mode-2 mask upsample at Cambridge's sizes (H/4 -> H at df 2 and
    4), equal to jax.image.resize's nearest."""
    from nefes_tpu_torch.cli.refine import nearest_upsample
    H, W = 480 // df, 854 // df
    m = np.random.default_rng(1).uniform(0, 1, (2, H // 4, W // 4)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(m)[..., None], (2, H, W, 1),
                            method="nearest")[..., 0]
    got = nearest_upsample(torch.from_numpy(m), H, W)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_options_match_jax(tmp_path):
    """The same fields and defaults as the JAX Options, plus device; a
    config txt and argv parse to the same values."""
    from nefes_tpu.cli.options import Options as JOptions
    from nefes_tpu.cli.options import options_from_cli as jparse
    from nefes_tpu_torch.cli.options import Options, options_from_cli
    jf = {f.name: f.default for f in fields(JOptions)}
    tf = {f.name: f.default for f in fields(Options)}
    assert set(tf) - set(jf) == {"device"} and set(jf) <= set(tf)
    assert {k: tf[k] for k in jf} == jf
    assert Options().device == "cuda"
    cfg = tmp_path / "config_chess_DFM.txt"
    cfg.write_text("# a DFM config\nexpname = chess_DFM\npose_only = 2\n"
                   "svd_reg = True\nfreezeBN=True\nlr_r = 0.0087\n"
                   "near_far = [0.2, 3.0]\nfeature_matching_lvl = [0]\n"
                   "tinyscale = 4\nft_path = None\neval = True\n")
    argv = ["--config", str(cfg), "--opt_iter", "7", "--set_near_far",
            "true", "--legacy_flag", "1"]
    want = jparse(argv)
    got = options_from_cli(argv + ["--device", "cpu"])
    assert {k: getattr(got, k) for k in jf} == {k: getattr(want, k)
                                                for k in jf}
    assert got.device == "cpu" and got.opt_iter == 7 and got.svd_reg
    assert got.near_far == (0.2, 3.0) and got.ft_path is None
    assert got.render_hw(240, 320) == want.render_hw(240, 320) == (60, 80)


def test_build_model_and_scene(fx):
    from nefes_tpu.cli.train import embed_configs as jembed
    from nefes_tpu_torch.cli.options import load_options
    from nefes_tpu_torch.cli.train import (
        build_model, build_scene, embed_configs, is_zoo_field,
    )
    paths = fx[0]
    opts = load_options(overrides=dict(
        datadir=paths["datadir"], data_root=paths["data_root"], df=8.0,
        dataset_type="7Scenes_colmap", netdepth=2, netwidth=32,
        feature_dim=8))
    for mode in (-1, 0, 1):
        opts.reduce_embedding = mode
        for got, want in zip(embed_configs(opts), jembed(opts)):
            assert got.out_dim == want.out_dim
            np.testing.assert_array_equal(got.freq_bands, want.freq_bands)
    opts.reduce_embedding = -1
    cfg, model = build_model(opts, device="cpu")
    assert (cfg.depth, cfg.width, cfg.feature_dim) == (2, 32, 8)
    assert next(model.parameters()).device.type == "cpu"
    scene = build_scene(opts, train=False)
    assert scene.images.shape == (4, 60, 80, 3)
    opts.ffmlp = True
    assert is_zoo_field(opts)
    with pytest.raises(NotImplementedError):
        build_model(opts, device="cpu")
    opts.ffmlp, opts.dataset_type = False, "LLFF"
    with pytest.raises(ValueError):
        build_scene(opts, train=False)
