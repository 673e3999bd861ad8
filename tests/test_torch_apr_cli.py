"""The port's refinement CLI with an APR of the zoo against the JAX CLI,
on the CPU in f32, on make_7scenes_fixture (df 8: 60×80 queries) with
tests/test_torch_cli.py's reference .tar and DFNet checkpoint (the
feature extractor, --pretrain_featurenet_path) and a reference-layout
PoseNetV2 checkpoint (backbone_net.* in torchvision's mobilenet_v2 layout
+ fc_pose.*, torch.save) as --pretrain_model_path, BN frozen, in mode 3
and mode 2 at test_torch_cli.py's settings: the pose txts agree to 2e-4,
the medians to 1e-3 m and 0.05°, as there.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from tests.test_backbone_convert import TMobileNetV2, _randomize_bn
from tests.test_torch_apr_convert import THead
from tests.test_torch_apr_zoo import _two_torch_threads  # noqa: F401
from tests.test_torch_cli import fx  # noqa: F401  (the fixture)


@pytest.fixture(scope="module")
def posenet_v2(fx):  # noqa: F811
    """A reference PoseNetV2 checkpoint whose pose starts near a test
    frame's pose."""
    paths, root, _, _ = fx
    torch.manual_seed(3)
    ref = THead(TMobileNetV2(), 1280).eval()
    _randomize_bn(ref)
    start = np.loadtxt(osp.join(paths["datadir"], "seq-02",
                                "frame-000001.pose.txt"))[:3].reshape(12)
    with torch.no_grad():
        ref.fc_pose.weight.mul_(0.01)
        ref.fc_pose.bias.copy_(torch.tensor(start, dtype=torch.float32))
    pt = osp.join(root, "posenetv2.pt")
    torch.save(ref.state_dict(), pt)
    return pt


def _argv(fx, apr_pt, mode, out):  # noqa: F811
    paths, _, tar, dfnet_pt = fx
    return ["--dataset_type", "7Scenes", "--datadir", paths["datadir"],
            "--data_root", paths["data_root"], "--df", "8",
            "--netdepth", "2", "--netwidth", "32", "--feature_dim", "128",
            "--N_samples", "8", "--N_importance", "8",
            "--pose_only", str(mode), "--opt_iter", "2", "--lr_r", "0.0087",
            "--lr_t", "0.01", "--ft_path", tar,
            "--PoseEstimatorType", "PoseNetV2",
            "--pretrain_model_path", apr_pt,
            "--pretrain_featurenet_path", dfnet_pt, "--freezeBN", "true",
            "--field_compute_dtype", "float32", "--save_dir", out]


@pytest.mark.parametrize("mode", [3, 2])
def test_refine_cli_posenetv2_matches_jax(fx, posenet_v2, mode):  # noqa: F811
    from nefes_tpu.cli.refine import main as jmain
    from nefes_tpu_torch.cli.refine import main as tmain
    root = fx[1]
    jout = osp.join(root, f"jax_posenetv2_{mode}")
    tout = osp.join(root, f"port_posenetv2_{mode}")
    want = jmain(_argv(fx, posenet_v2, mode, jout))
    got = tmain(_argv(fx, posenet_v2, mode, tout) + ["--device", "cpu"])
    name = "PoseNetV2_chess_NeFeS2_APR_pose_results.txt"
    jp, tp = np.loadtxt(osp.join(jout, name)), np.loadtxt(osp.join(tout, name))
    assert tp.shape == (4, 12) and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-4)
    assert got["n_frames"] == want["n_frames"] == 4
    assert abs(got["median_t_m"] - want["median_t_m"]) < 1e-3
    assert abs(got["median_r_deg"] - want["median_r_deg"]) < 0.05


@pytest.mark.parametrize("mode", [3, 2])
@pytest.mark.parametrize("kind", ["PoseNet", "PoseNetV2", "EfficientNetB3",
                                  "MapNet", "MsTransformer"])
def test_refine_cli_runs_every_kind(fx, kind, mode):  # noqa: F811
    """Every kind the JAX CLI accepts runs in both modes (seeded random
    APR weights, BN on batch statistics as the CLI defaults, one
    iteration) and writes a finite pose txt."""
    from nefes_tpu_torch.cli.refine import main
    paths, root, tar, dfnet_pt = fx
    out = osp.join(root, f"every_{kind}_{mode}")
    argv = _argv(fx, "", mode, out)
    argv[argv.index("--opt_iter") + 1] = "1"
    argv[argv.index("--PoseEstimatorType") + 1] = kind
    argv[argv.index("--pretrain_model_path") + 1] = ""
    i = argv.index("--freezeBN")           # the default: batch statistics
    del argv[i:i + 2]
    got = main(argv + ["--device", "cpu"])
    poses = np.loadtxt(osp.join(
        out, f"{kind}_chess_NeFeS1_APR_pose_results.txt"))
    assert got["n_frames"] == 4
    assert poses.shape == (4, 12) and np.isfinite(poses).all()
