"""The port's training CLI (nefes_tpu_torch.cli.train) against the JAX
package's, on the CPU, end to end on make_7scenes_fixture (df 8: 60×80
images rendered at 15×20; depth 2, width 32, 8 features, 4 + 4 samples,
32 rays an image, batches of 2), as tests/test_cli_e2e.py drives the JAX
one, each run with the same flags through both (the port's with
--device cpu, where the kernels' plain versions run):

* stage 1 for 3 epochs, then a stage-2 run from its checkpoint
  (--ft_path): the epoch and the optimizer reset;
* periodic validation with DFNet's features; the --render_test exit;
* validation videos, and the --render_pose_only spiral;
* a windowed run (reduce_embedding 2) and an aux run (TV and both sigma
  sparsities).

For each: the files written (checkpoints by their epochs: orbax
directories against torch.save files), the keys of every metrics.jsonl
line with its epoch and stage, args.txt's keys (the port's adds
`device`) and the returned epoch are the JAX CLI's. Also precompute_targets
against the JAX one on the same DFNet weights (1e-5), and main without a
card refusing the default --device cuda.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixture_datasets import make_7scenes_fixture

# (name, flags); "ckpt" is replaced by the stage-1 run's last checkpoint
RUNS = (
    ("stage1", dict(epochs=2, new_schedule=1)),
    ("stage2", dict(epochs=1, new_schedule=2, ft_path="ckpt",
                    no_reload=True)),
    ("valrun", dict(epochs=1, new_schedule=1, i_testset=1,
                    color_feat_loss=True)),
    ("rt", dict(epochs=50, new_schedule=1, render_test=True,
                ft_path="ckpt")),
    ("vid", dict(epochs=1, new_schedule=1, i_testset=1,
                 render_video_train=True, render_video_test=True)),
    ("spiral", dict(epochs=50, new_schedule=1, render_pose_only=True,
                    spiral_views=3, ft_path="ckpt")),
    ("window", dict(epochs=1, new_schedule=1, reduce_embedding=2)),
    ("aux", dict(epochs=0, new_schedule=1, tvloss=True,
                 sigma_sparsity_loss=True, sigma_sparsity_loss2=True)),
)


def _argv(paths, basedir, name, flags, ckpt):
    base = {
        "dataset_type": "7Scenes", "datadir": paths["datadir"],
        "data_root": paths["data_root"], "basedir": basedir,
        "expname": name, "df": "8", "netdepth": "2", "netwidth": "32",
        "feature_dim": "8", "multires": "4", "multires_views": "2",
        "N_samples": "4", "N_importance": "4", "N_rand": "32",
        "batch_size": "2", "i_weights": "1", "i_print": "1",
        "i_testset": "0", "val_views": "1", "tinyscale": "4",
    }
    base.update({k: str(ckpt if v == "ckpt" else v)
                 for k, v in flags.items()})
    return [a for k, v in base.items() for a in (f"--{k}", v)]


def _record(expdir):
    """What a run wrote: every file (checkpoints by their entry names,
    without the port's .pt), metrics.jsonl's keys, epochs and stages per
    line, args.txt's keys."""
    files = set()
    for dp, dns, fns in os.walk(expdir):
        rel = os.path.relpath(dp, expdir)
        if rel == "ckpts":
            files |= {f"ckpts/{os.path.splitext(x)[0]}" for x in dns + fns}
            dns[:] = []
            continue
        files |= {os.path.normpath(os.path.join(rel, f)) for f in fns}
    metrics = []
    if os.path.exists(os.path.join(expdir, "metrics.jsonl")):
        with open(os.path.join(expdir, "metrics.jsonl")) as f:
            metrics = [(sorted(r), r["epoch"], r["stage"])
                       for r in map(json.loads, f)]
    with open(os.path.join(expdir, "args.txt")) as f:
        args = {line.split(" = ")[0] for line in f if " = " in line}
    return files, metrics, args


def _run_all(main, paths, basedir, extra):
    out, ckpt = {}, None
    for name, flags in RUNS:
        state = main(_argv(paths, basedir, name, flags, ckpt) + extra)
        out[name] = (int(state.epoch), *_record(os.path.join(basedir, name)))
        if name == "stage1":
            ck = os.path.join(basedir, name, "ckpts")
            ckpt = os.path.join(ck, sorted(os.listdir(ck))[-1])
    return out


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    return make_7scenes_fixture(root), root


@pytest.fixture(scope="module")
def runs(fx):
    from nefes_tpu.cli.train import main as jmain
    from nefes_tpu_torch.cli.train import main as tmain
    paths, root = fx
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = _run_all(tmain, paths, os.path.join(root, "port"),
                        ["--device", "cpu"])
    finally:
        torch.set_num_threads(n_threads)
    return _run_all(jmain, paths, os.path.join(root, "jax"), []), port


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_cli_run_writes_what_jax_writes(runs, name):
    want, got = runs
    j_epoch, j_files, j_metrics, j_args = want[name]
    p_epoch, p_files, p_metrics, p_args = got[name]
    assert p_epoch == j_epoch
    assert p_files == j_files
    assert p_metrics == j_metrics
    assert p_args == j_args | {"device"}
    if name == "stage2":
        # the stage-2 entry reset the clock: epochs 0..1 of stage 1
        assert [(e, s) for _, e, s in p_metrics] == [(0, 1), (1, 1)]
    if name in ("valrun", "vid"):
        assert any(f.startswith("evaluate_val_000001/") for f in p_files)
    if name == "spiral":
        assert "spiral_spiral.mp4" in p_files


def test_spiral_video_frames(fx, runs):
    from nefes_tpu_torch.utils.video import read_mp4
    _, root = fx
    frames = read_mp4(os.path.join(root, "port", "spiral",
                                   "spiral_spiral.mp4"))
    assert frames.shape == (3, 15 * 4, 20 * 4, 3)


def test_precompute_targets_matches_jax(fx):
    """The target rgb at the render size and DFNet's features of it, on
    the same DFNet weights, to 1e-5."""
    from nefes_tpu.cli.options import load_options as jload
    from nefes_tpu.cli.train import build_scene as jbuild
    from nefes_tpu.cli.train import precompute_targets as jpre
    from nefes_tpu.features.dfnet import DFNet as JDFNet
    from nefes_tpu_torch.cli.options import load_options
    from nefes_tpu_torch.cli.train import build_scene, precompute_targets
    from nefes_tpu_torch.features.dfnet import DFNet
    from nefes_tpu_torch.weights import dfnet_from_jax_variables
    paths, _ = fx
    kw = {"dataset_type": "7Scenes", "datadir": paths["datadir"],
          "data_root": paths["data_root"], "df": "8", "feature_dim": "8"}
    jopts, topts = jload(None, kw), load_options(None, kw)
    jscene, tscene = jbuild(jopts, True), build_scene(topts, True)
    h, w = topts.render_hw(tscene.H, tscene.W)
    jd = JDFNet(output_dim=8)
    dv = jd.init(jax.random.key(1), jnp.zeros((1, jscene.H, jscene.W, 3)),
                 upsample_hw=(h, w))
    dv = jax.tree.map(lambda x: np.asarray(x, np.float32), dv)
    td = DFNet(output_dim=8, device="cpu")
    td.load_state_dict(dfnet_from_jax_variables(dv))
    want_rgb, want_feat = jpre(jopts, jscene, (jd, dv))
    got_rgb, got_feat = precompute_targets(topts, tscene, td, "cpu")
    for got, want in ((got_rgb, want_rgb), (got_feat, want_feat)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_main_needs_the_card_by_default(fx):
    from nefes_tpu_torch.cli.train import main
    paths, root = fx
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_argv(paths, os.path.join(root, "nocard"), "x", {}, None))


def test_fresh_model_draws_flax_initialisers():
    """The model the training CLI starts from (no checkpoint) has the
    JAX CLI's initial distribution (create_train_state(model, key(0)):
    flax's lecun_normal kernels, zero biases), at the CLI's default
    architecture: every bias exactly 0; each Linear / Conv2d weight's std
    within 10 % of the JAX init's at the same parameter (or within 4
    standard errors of the two samples' difference, 4 * 0.59 * sqrt(2 /
    n), where a weight has too few elements n for 10 %); no weight beyond
    2 std of the untruncated normal (flax truncates there)."""
    from nefes_tpu.cli.options import options_from_cli as jax_options
    from nefes_tpu.cli.train import build_model as jax_build_model
    from nefes_tpu_torch.cli.options import options_from_cli
    from nefes_tpu_torch.cli.train import init_train_model
    from nefes_tpu_torch.weights import from_jax_variables

    cfg, model = init_train_model(options_from_cli([]), "cpu")
    jcfg, jmodel = jax_build_model(jax_options([]))
    want = from_jax_variables(
        jax.tree.map(np.asarray, jmodel.init_variables(jax.random.key(0))),
        cfg)
    n_weights = 0
    for name, mod in model.named_modules():
        if not isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            continue
        n_weights += 1
        assert torch.count_nonzero(mod.bias) == 0, name
        w, jw = mod.weight.detach(), want[f"{name}.weight"]
        assert w.shape == jw.shape, name
        n = w.numel()
        tol = max(0.10, 4 * 0.59 * (2.0 / n) ** 0.5)
        rel = abs(float(w.std()) / float(jw.std()) - 1.0)
        assert rel <= tol, (name, rel, tol)
        bound = 2 * w[0].numel() ** -0.5 / .87962566103423978
        assert float(w.abs().max()) <= bound * (1 + 1e-6), name
        assert float(jw.abs().max()) <= bound * (1 + 1e-6), name
    assert n_weights == sum(1 for k in want if k.endswith(".weight")
                            and "bn" not in k)
