"""The comparison that decides `correct`, shown to fail: the control (the
reference computed in the precision below the configuration's, put in
the program's place) and runs whose timed path is broken underneath,
each driven through the rest of a run at the tiny size on the CPU (the
look for a card skipped), must come out not correct; the sound program
comes out correct."""

import pytest
import torch

from benchmark.harness import Checks
from benchmark.tests.tiny import SEED, TINY, cell, result_tiny

REFINE = [("dfnet-mode2", None), ("dfnet-mode3", None),
          ("mstrans-mode2", None)]


@pytest.mark.parametrize("name", [c for c, _ in REFINE] + ["field-train"])
def test_sound_program_is_correct(name):
    assert result_tiny(cell(name))["correct"]


@pytest.mark.parametrize("name", [c for c, _ in REFINE])
def test_refine_control_is_not_correct(name):
    from benchmark.control import refine_control
    c = cell(name)
    numbers = refine_control(c, SEED, torch.device("cpu"), TINY)["control"]
    checks = Checks(c.limits, numbers)
    assert not checks.correct, checks.lines()


@pytest.mark.parametrize("fault", ["control", "half_batch"])
def test_train_control_and_half_batch_are_not_correct(fault):
    from benchmark.control import train_control
    c = cell("field-train")
    numbers = train_control(c, SEED, torch.device("cpu"), TINY)[fault]
    checks = Checks(c.limits, numbers)
    assert not checks.correct, checks.lines()


def _single(name: str) -> tuple:
    """The module of a cell's serving step, its eager refinement loop
    (what the serving step runs on a CPU tensor) and the position of the
    loop's RefineConfig."""
    from nefes_tpu_torch.refine import apr_opt, pose_opt
    return ((pose_opt, "refine_pose_single", 9) if name == "dfnet-mode3"
            else (apr_opt, "refine_apr_single", 11))


@pytest.mark.parametrize("name", [c for c, _ in REFINE])
def test_refine_state_unchanged_is_not_correct(name, monkeypatch):
    from dataclasses import replace
    module, fn_name, at = _single(name)
    orig = getattr(module, fn_name)

    def frozen(*a, **k):
        a = list(a)
        a[at] = replace(a[at], learning_rate=0.0, lr_r=0.0, lr_t=0.0)
        return orig(*a, **k)
    monkeypatch.setattr(module, fn_name, frozen)
    assert not result_tiny(cell(name))["correct"]


def test_dfnet_trunk_gradient_left_out_is_not_correct(monkeypatch):
    """Mode 2 with the APR's backward into its convolutional trunk left
    out: DFNet's pose head reads its pooled features detached, so only
    the head learns."""
    from nefes_tpu_torch.features import dfnet
    orig = dfnet.DFNet.forward

    def forward(self, *a, **k):
        if not self.fc_pose._forward_pre_hooks:
            self.fc_pose.register_forward_pre_hook(
                lambda m, inp: tuple(x.detach() for x in inp))
        return orig(self, *a, **k)
    monkeypatch.setattr(dfnet.DFNet, "forward", forward)
    assert not result_tiny(cell("dfnet-mode2"))["correct"]


@pytest.mark.parametrize("name", [c for c, _ in REFINE])
def test_refine_answer_altered_is_not_correct(name, monkeypatch):
    """The pose altered where the program produces it: the APR's pose
    (mode 2) or the refined pose of each step (mode 3), moved 5 cm."""
    from nefes_tpu_torch.refine import apr_opt, pose_opt

    def moved(pose):
        return torch.cat([pose[..., :3], pose[..., 3:] + 0.05], dim=-1)
    if name == "dfnet-mode3":
        orig = pose_opt._pose_from
        monkeypatch.setattr(pose_opt, "_pose_from", lambda *a: tuple(
            moved(p) for p in orig(*a)))
    else:
        orig = apr_opt.apr_pose_any
        monkeypatch.setattr(apr_opt, "apr_pose_any",
                            lambda *a, **k: moved(orig(*a, **k)))
    assert not result_tiny(cell(name))["correct"]


def test_train_state_unchanged_is_not_correct(monkeypatch):
    from nefes_tpu_torch.train import trainer
    monkeypatch.setattr(trainer.Adam, "step", lambda self, lr: None)
    assert not result_tiny(cell("field-train"))["correct"]


def test_train_half_batch_is_not_correct(monkeypatch):
    from nefes_tpu_torch.train import trainer
    orig = trainer.nefes_training_loss

    def half(out, target_rgb, target_feat, *a, **k):
        n = target_rgb.shape[1] // 2
        out = {key: (v[:, :n] if torch.is_tensor(v) and v.dim() >= 2
                     else v) for key, v in out.items()}
        return orig(out, target_rgb[:, :n], target_feat[:, :n], *a, **k)
    monkeypatch.setattr(trainer, "nefes_training_loss", half)
    assert not result_tiny(cell("field-train"))["correct"]
