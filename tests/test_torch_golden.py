"""The port's golden command (nefes_tpu_torch/runtime/probe.py cmd_golden)
on the synthetic reference-layout fixture that tests/test_golden_drive.py
builds for the JAX command (a NeFeS .tar, a DFNet .pt, a 7-Scenes scene,
a paper_result tree whose "paper" poses are the ground truth), run in
process on the CPU with that test's reduced flags:

- loose tolerances (1e9) PASS, tolerances of -1 raise SystemExit with a
  non-zero code and write a failing verdict;
- the verdict has the JAX command's keys, and its paper_* medians are
  those of nefes_tpu.evaluation.golden.evaluate_scene on the same tree
  (1e-9);
- the refine CLI gets the JAX command's argv (and --device), and ours_*
  are its summary, the same in both runs.

The JAX command runs with its refine CLI replaced by one returning the
port's summary: its verdict's keys and paper medians are the reference.
"""

import json
from types import SimpleNamespace

import pytest

from nefes_tpu_torch.runtime import probe
from tests.test_golden_drive import artifacts  # noqa: F401  (fixture)

EXTRA = ["--N_samples", "8", "--N_importance", "8", "--tinyscale", "2"]


def _argv(a, out, tol):
    return ["golden", "--device", "cpu", "--tar", a["tar"], "--apr",
            a["apr"], "--scene", "chess", "--datadir", a["datadir"],
            "--data_root", a["data_root"], "--dataset_type",
            "7Scenes_colmap", "--ref", a["ref"], "--df", "8", "--opt_iter",
            "2", "--apr_compute_dtype", "float32", "--tol_t", str(tol),
            "--tol_r", str(tol), "--out", out, "--extra_args", *EXTRA]


@pytest.fixture(scope="module")
def runs(artifacts, tmp_path_factory):  # noqa: F811
    """The port's command at tolerance 1e9 and -1: (verdict, the refine
    CLI's argv and summary, the exit) of each."""
    import os

    import nefes_tpu_torch.cli.refine as cli
    out_dir = tmp_path_factory.mktemp("golden_torch")
    real, got, cwd = cli.main, {}, os.getcwd()

    def recorded(argv):
        got["argv"], got["summary"] = argv, real(argv)
        return got["summary"]
    cli.main = recorded
    os.chdir(out_dir)           # the CLI writes its pose txt under tmp/
    res = {}
    try:
        for tol in (1e9, -1.0):
            out = str(out_dir / f"GOLDEN_{tol}.json")
            got.clear()
            try:
                code = probe.main(_argv(artifacts, out, tol))
            except SystemExit as e:
                code = e.code
            with open(out) as f:
                res[tol] = (json.load(f), dict(got), code)
    finally:
        cli.main = real
        os.chdir(cwd)
    return res


@pytest.fixture(scope="module")
def jax_verdict(artifacts, runs, tmp_path_factory):  # noqa: F811
    """The JAX command's verdict and refine argv, its refine CLI replaced
    by one that returns the port's summary."""
    import nefes_tpu.cli.refine as jcli
    from runtime import probe as jprobe
    _, got, _ = runs[1e9]
    seen = {}

    def stub(argv):
        seen["argv"] = argv
        return got["summary"]
    real, jcli.main = jcli.main, stub
    out = str(tmp_path_factory.mktemp("golden_jax") / "GOLDEN.json")
    try:
        jprobe.cmd_golden(SimpleNamespace(
            tar=artifacts["tar"], apr=artifacts["apr"], featurenet="",
            scene="chess", datadir=artifacts["datadir"],
            data_root=artifacts["data_root"],
            dataset_type="7Scenes_colmap", ref=artifacts["ref"], df=8,
            opt_iter=2, apr_compute_dtype="float32", tol_t=1e9, tol_r=1e9,
            out=out, extra_args=EXTRA))
    finally:
        jcli.main = real
    with open(out) as f:
        return json.load(f), seen["argv"]


def test_golden_pass_and_fail(runs):
    v, got, code = runs[1e9]
    assert code == 0 and v["pass"] is True
    v2, _, code2 = runs[-1.0]
    assert code2 not in (0, None) and "[golden] FAIL" in str(code2)
    assert v2["pass"] is False


def test_golden_verdict_is_the_jax_commands(artifacts, runs,  # noqa: F811
                                            jax_verdict):
    from nefes_tpu.evaluation.golden import evaluate_scene, paper_result_dir
    want, _ = jax_verdict
    v, _, _ = runs[1e9]
    assert set(v) == set(want)
    scene = paper_result_dir(artifacts["ref"], "7Scenes_colmap") / "chess"
    for refined, key in ((True, "paper"), (False, "paper_apr")):
        med = evaluate_scene(scene, "chess", refined=refined)
        for m in ("median_t_m", "median_r_deg"):
            assert abs(v[f"{key}_{m}"] - float(med[m])) <= 1e-9
            assert abs(v[f"{key}_{m}"] - want[f"{key}_{m}"]) <= 1e-9
    for k in ("ours_median_t_m", "ours_median_r_deg", "delta_t_m",
              "delta_r_deg", "tol_t_m", "tol_r_deg", "pass", "scene",
              "dataset"):
        assert v[k] == want[k], k


def test_golden_refines_through_the_cli(runs, jax_verdict):
    _, jax_argv = jax_verdict
    v, got, _ = runs[1e9]
    v2, got2, _ = runs[-1.0]
    n = len(jax_argv) - len(EXTRA)
    assert got["argv"] == jax_argv[:n] + ["--device", "cpu"] + EXTRA
    assert got2["argv"] == got["argv"]
    for verdict in (v, v2):
        for m in ("median_t_m", "median_r_deg"):
            assert verdict[f"ours_{m}"] == float(got["summary"][m])
