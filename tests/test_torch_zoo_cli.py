"""The field zoo through the port's CLIs on the CPU, on
make_7scenes_fixture at tests/test_field_zoo.py's sizes (df 8, depth 2,
width 16, 4 + 4 samples, 16 rays, batch 2): the training CLI trains the
hash field (--tcnn, with --l1normloss) and the legacy NeRF-W field
(--nerfh_nff False) end to end, resumes the hash field from its
checkpoint and renders the NeRF-W run's test views (--render_test); it
refuses the feature and fusion losses for a zoo field, as the JAX CLI
does; the refinement CLI refuses a zoo field before it loads the scene
(it has no feature head for the DFM loss)."""

import json
import os

import pytest
import torch

from tests.fixture_datasets import make_7scenes_fixture


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoocli")
    return make_7scenes_fixture(str(root)), str(root)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(paths, root, **kw):
    base = {
        "dataset_type": "7Scenes", "datadir": paths["datadir"],
        "data_root": paths["data_root"], "basedir": os.path.join(root, "logs"),
        "df": "8", "netdepth": "2", "netwidth": "16",
        "multires": "2", "multires_views": "1",
        "N_samples": "4", "N_importance": "4", "N_rand": "16",
        "batch_size": "2", "i_weights": "1", "i_print": "1",
        "i_testset": "0", "val_views": "1", "tinyscale": "4",
        "epochs": "1", "new_schedule": "1", "device": "cpu",
    }
    base.update({k: str(v) for k, v in kw.items()})
    argv = []
    for k, v in base.items():
        argv += [f"--{k}", v]
    return argv


def _metrics(root, exp):
    with open(os.path.join(root, "logs", exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_hash_field_and_resumes(fx, capsys):
    from nefes_tpu_torch.cli.train import main
    paths, root = fx
    kw = dict(expname="hashrun", tcnn=True, hash_level=2, bound=4.0,
              l1normloss=True)
    s = main(_args(paths, root, **kw))
    assert s.epoch == 2 and s.model.cfg.kind == "hash"
    names = dict(s.model.named_parameters())
    assert "coarse.encoder.level_1" in names and "embed_a.embedding" in names
    assert "l1normloss" not in capsys.readouterr().out   # not dropped
    ckpts = os.path.join(root, "logs", "hashrun", "ckpts")
    assert sorted(os.listdir(ckpts)) == ["epoch_000001.pt"]
    recs = _metrics(root, "hashrun")
    assert [r["epoch"] for r in recs] == [0, 1]
    assert {"loss", "loss_rgb", "psnr"} <= set(recs[0])
    # resumed from its checkpoint (saved after epoch 1): the tables and
    # the optimizer come back, epoch 2 runs
    table = s.model.coarse.encoder.level_1.detach().clone()
    s2 = main(_args(paths, root, epochs=2, i_weights=2, **kw))
    assert "restoring from" in capsys.readouterr().out
    assert s2.epoch == 3 and s2.tx.count > s.tx.count
    assert [r["epoch"] for r in _metrics(root, "hashrun")] == [0, 1, 2]
    assert not torch.equal(s2.model.coarse.encoder.level_1.detach(), table)


def test_cli_trains_legacy_nerfw_field_and_renders(fx, capsys):
    from nefes_tpu_torch.cli.train import main
    paths, root = fx
    s = main(_args(paths, root, expname="nerfwrun", nerfh_nff=False,
                   l1normloss=True))
    # l1normloss regularises hash tables: dropped with its warning
    assert "l1normloss regularises hash-grid tables; ignored" in \
        capsys.readouterr().out
    assert s.model.cfg.kind == "nerfw" and hasattr(s.model, "embed_a")
    assert all(torch.isfinite(torch.tensor(r["loss"]))
               for r in _metrics(root, "nerfwrun"))
    main(_args(paths, root, expname="nerfwrun", nerfh_nff=False,
               render_test=True))
    outs = [d for d in os.listdir(os.path.join(root, "logs", "nerfwrun"))
            if d.startswith("evaluate_")]
    assert sorted(outs) == ["evaluate_train_000002", "evaluate_val_000002"]
    for d in outs:
        files = os.listdir(os.path.join(root, "logs", "nerfwrun", d))
        assert {"000.png", "000_GT.png", "000_disp.png"} <= set(files)


@pytest.mark.parametrize("flag", ["color_feat_loss", "new_schedule"])
def test_cli_refuses_feature_losses_for_zoo_fields(fx, flag):
    from nefes_tpu_torch.cli.train import main
    paths, root = fx
    kw = {flag: 2 if flag == "new_schedule" else True}
    with pytest.raises(ValueError, match="feature"):
        main(_args(paths, root, expname="bad", tcnn=True, **kw))


@pytest.mark.parametrize("flag", [("tcnn", "true"), ("NeRFW", "false"),
                                  ("nerfh_nff", "false")])
def test_refine_cli_refuses_zoo_fields(flag):
    """Refused with ValueError before the scene loads: the datadir does
    not exist."""
    from nefes_tpu_torch.cli.refine import main
    with pytest.raises(ValueError, match="feature head"):
        main(["--datadir", "/nonexistent/chess", "--pose_only", "2",
              "--device", "cpu", f"--{flag[0]}", flag[1]])
