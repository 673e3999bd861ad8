"""The plain reference held against the program at tiny sizes on the
CPU, from the same weights and inputs: the whole refinement frame (APR,
feature extraction, field, render, exposure, FusionNet, resize, DFM
loss, Adam, verification) in modes 2 and 3 with DFNet and MS-Transformer,
and the stage-1 training steps. Both sides compute in float32 here, so
they agree to rounding."""

import pytest

from benchmark.tests.tiny import cell, run_tiny

REFINE = [("dfnet-mode2", None), ("dfnet-mode3", None),
          ("dfnet-mode2", "configs/nefes_mstransformer.json")]


@pytest.mark.parametrize("name,config_file", REFINE)
def test_refinement_frame_matches_reference(name, config_file):
    """Mode 3's sign-like Adam steps at lr_t 0.1 carry rounding into its
    pose (ten steps of two float32 programs part by about 1 % of the
    move), so its answer is held by the loss the reference gives it."""
    n = run_tiny(cell(name, config_file))["checks"].numbers
    assert n["loss0"] < 1e-5, n
    assert n["initial_pose"] < 1e-5, n
    assert n["last_loss"] < 1e-4, n
    assert n["answer_loss"] < 1e-4, n
    if name != "dfnet-mode3":
        assert n["refined_rel"] < 1e-2, n
    assert n.get("verify_wrong", 0.0) == 0.0, n


def test_training_steps_match_reference():
    n = run_tiny(cell("field-train"))["checks"].numbers
    assert max(n[f"loss_step{i}"] for i in (1, 2, 3)) < 1e-6, n
    assert n["grad"] < 1e-4, n
    assert n["change"] < 1e-3, n
