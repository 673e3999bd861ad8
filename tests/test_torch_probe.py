"""The port's probe CLI (nefes_tpu_torch/runtime/probe.py) and its
micro-benchmark kernels K9-K12 (kernels/micro.py, csrc/micro.cu).

1. The plain versions (what a wrapper runs for a CPU tensor) against the
   JAX probe's own Pallas kernels of cmd_kernelmicro in interpret mode, on
   the inputs that command makes: the JAX command runs once per module at
   N = 2048 (H, W = 1, 16) with pallas_call recorded (interpret=True) and
   timeit recorded, not run; each recorded kernel then runs on the inputs
   its timed lambda closes over. Chains: relative L2 <= 2e-3 in bf16 (the
   same products summed in another order; a unit within one bf16 rounding
   of 0 may land on the other side of a ReLU). The embedding: equal bit
   for bit (f32 phases x·2^k are exact, sin/cos agree to well inside
   one bf16 rounding).
2. The chain's packed weights (pack_chain) read back, by this file's own
   statement of the layout (K-slices of 64 inputs, each output's row of
   8 swizzled chunks of 8, the last layer's outputs permuted), to every
   matrix. csrc/micro.cu built for the host (NEFES_EMULATE, one thread a
   CTA, 3 resident CTAs): its f32 kernels, which walk the card's units and
   passes and read the same blob, against the plain versions, within 1e-6
   relative, at several tiles, both widths, both interleavings and
   CTAs whose last pass is partial; shapes the kernels do not take
   raise.
3. The probe's commands on the CPU (--device cpu: the plain versions) at
   a cut H, W, with timeit calling each function once: kernelmicro's keys
   are the JAX command's, every number is finite. inscan_ab and profile
   at H, W = 8, 8 and 2 iterations a frame: the JAX commands' keys (the
   dicts of its inscan_ab's source; PROFILE_r05.json, its profile's
   record), every number finite, the phases summing to the busy time.
4. On a card (marked cuda; skipped without one): each bf16 kernel against
   its plain version.
"""

import ctypes
import inspect
import json
import math
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels import micro as km
from nefes_tpu_torch.runtime import probe
from tests.torch_parity import n

JAX_N = 2048     # H * W * 128 at H, W = 1, 16
# (case id, kernel, tile, sub-tiles interleaved): the order in which the
# JAX command builds its Pallas kernels and times them
CASES = [("K9-tile512", "chain", 512, 1), ("K9-tile2048", "chain", 2048, 1),
         ("K10-x2", "interleaved", 2048, 2), ("K10-x4", "interleaved", 2048, 4),
         ("K11-tile512", "embed", 512, 1), ("K11-tile2048", "embed", 2048, 1),
         ("K12-w128", "sq", 2048, 1), ("K12-w256", "sq", 512, 1)]


@pytest.fixture(scope="module")
def jax_micro(tmp_path_factory):
    """{"keys": the JAX command's result keys, case id: (numpy inputs,
    the interpret-mode kernel's output)}."""
    import jax.experimental.pallas as pl
    env = dict(os.environ)
    try:
        import runtime.probe as jprobe      # sets JAX cache variables
    finally:
        os.environ.clear()
        os.environ.update(env)
    real = pl.pallas_call
    built, timed = [], []

    def recorder(*a, **kw):
        fn = real(*a, **{**kw, "interpret": True})
        built.append(fn)
        return fn

    def record_timeit(name, fn, n=10):
        timed.append(fn)
        return 1e-3

    out = tmp_path_factory.mktemp("jax_probe") / "kernelmicro.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recorder)
        mp.setattr(jprobe, "timeit", record_timeit)
        mp.setattr(jprobe, "H", 1)
        mp.setattr(jprobe, "W", 16)
        jprobe.cmd_kernelmicro(SimpleNamespace(tiles=[512, 2048],
                                               out=str(out)))
    assert len(built) == len(CASES)
    res = {"keys": set(json.loads(out.read_text()))}
    for (case, kind, _, _), kern, fn in zip(CASES, built, timed):
        env_ = inspect.getclosurevars(fn).nonlocals
        if kind == "embed":
            args = (env_["pts"],)
        else:
            args = (env_["x_in" if kind != "sq" else "x"], *env_["ws"])
        res[case] = ([np.array(a, np.float32) for a in args],
                     np.asarray(kern(*args), np.float32))
    return res


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _rel_l2(got, want) -> float:
    got, want = n(got).astype(np.float64), n(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case,kind,tile,nb", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas(jax_micro, case, kind, tile, nb):
    """The wrappers on CPU tensors (the plain versions) against the JAX
    probe's kernels on its inputs."""
    args, want = jax_micro[case]
    if kind == "embed":
        got = km.embed_micro(torch.from_numpy(args[0]), tile)
        assert got.dtype == torch.bfloat16 and got.shape == (JAX_N, 64)
        np.testing.assert_array_equal(n(got), want)
        return
    cw = km.pack_chain([_bf16(w) for w in args[1:]])
    x = _bf16(args[0])
    got = {"chain": lambda: km.chain(cw, x, tile),
           "interleaved": lambda: km.chain_interleaved(cw, x, tile, nb),
           "sq": lambda: km.chain_sq(cw, x, tile)}[kind]()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() > 0
    assert _rel_l2(got, want) <= 2e-3


# --- csrc/micro.cu built for the host ---

@pytest.fixture(scope="module")
def micro_lib(tmp_path_factory):
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    path = tmp_path_factory.mktemp("host_build")
    return build.library("micro", emulate=True, build_dir=path)


def _chain_case(width_in, width, rows, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cw = km.pack_chain(torch.randn((width_in if i == 0 else width, width),
                                   generator=gen) * 0.05 for i in range(8))
    return cw, torch.randn((rows, width_in), generator=gen)


@pytest.mark.parametrize("E,W", [(64, 128), (128, 128), (256, 256)],
                         ids=["K9", "K12-w128", "K12-w256"])
def test_pack_chain_layout(E, W):
    """Element (k, p) of layer l's slice s = k // 64 sits at row p, chunk
    (k % 64 // 8) ^ (p % 8), place k % 8; row p of the last layer holds
    output column 32 (p // 32) + 8 (p // 2 % 4) + 2 (p // 8 % 4) + p % 2."""
    cw, _ = _chain_case(E, W, 64)
    blob = cw.w.numpy()
    assert blob.size == E * W + 7 * W * W
    off = 0
    for layer, w in enumerate(cw.ws):
        K, m = w.shape[0], np.empty((w.shape[0], W), np.float32)
        for k in range(K):
            for p in range(W):
                col = p
                if layer == cw.D - 1:
                    col = ((p // 32) * 32 + (p // 2 % 4) * 8
                           + (p // 8 % 4) * 2 + p % 2)
                chunk = (k % 64 // 8) ^ (p % 8)
                m[k, col] = blob[off + ((k // 64) * W + p) * 64 + chunk * 8
                                 + k % 8]
        np.testing.assert_array_equal(m, w.numpy())
        off += K * W
    assert sorted(km.chain_out_col(torch.arange(W)).tolist()) == list(range(W))


# (chain input width, width, rows, tile, sub-tiles): one and several
# CTAs and units a CTA, passes across units (tile 64) and units across
# passes, a CTA whose last pass holds fewer m-tiles than the pass (the
# "ragged" cases: 5 units over 3 CTAs), both interleavings, both square
# widths
@pytest.mark.parametrize("E,W,rows,tile,nb", [
    pytest.param(64, 128, 512, 64, 1, id="K9-tile64"),
    pytest.param(64, 128, 320, 64, 1, id="K9-ragged"),
    pytest.param(64, 128, 320, 64, 2, id="K10-x2-ragged"),
    pytest.param(64, 128, 512, 256, 1, id="K9-tile256"),
    pytest.param(64, 128, 512, 256, 2, id="K10-x2"),
    pytest.param(64, 128, 512, 512, 4, id="K10-x4"),
    pytest.param(128, 128, 256, 128, 1, id="K12-w128"),
    pytest.param(256, 256, 256, 128, 1, id="K12-w256")])
def test_chain_source_matches_plain(micro_lib, E, W, rows, tile, nb):
    cw, x = _chain_case(E, W, rows)
    out = torch.empty((rows, W))
    assert micro_lib.nefes_micro_chain(
        0, rows, tile, nb, E, W, cw.D, x.data_ptr(), cw.w.data_ptr(),
        out.data_ptr(), None) == 0
    want = km.chain_plain(cw, x)
    assert (want > 0).float().mean() > 0.3
    assert _rel_l2(out, want) <= 1e-6


@pytest.mark.parametrize("tile", [64, 512])
def test_embed_source_matches_plain(micro_lib, tile):
    """Points at scene scale and beyond: the top band's phases reach
    thousands of radians."""
    pts = torch.randn((1024, 3), generator=torch.Generator().manual_seed(1)) * 4
    out = torch.empty((1024, km.EMBED_COLS))
    assert micro_lib.nefes_micro_embed(0, 1024, tile, pts.data_ptr(),
                                       out.data_ptr(), None) == 0
    want = km.embed_micro_plain(pts, torch.float32)
    assert torch.equal(out[:, 60:], torch.zeros(1024, 4))
    assert _rel_l2(out, want) <= 1e-6


def test_shapes_the_kernels_refuse(micro_lib):
    """A tile that does not divide N or is no multiple of a 64-row
    m-tile, a width, input width or interleaving the chain kernel does
    not take, raises in the wrapper (pack_chain for the weights) and is
    refused by the kernel's entry point (-4); the host build refuses bf16
    (-1), before any pointer is read."""
    cw, x = _chain_case(64, 128, 512)
    with pytest.raises(ValueError, match="tile 192"):
        km.chain(cw, x, 192)
    with pytest.raises(ValueError, match="tile 96"):
        km.chain_interleaved(cw, x, 96, 4)
    with pytest.raises(ValueError, match="n_blocks = 3"):
        km.chain_interleaved(cw, x, 128, 3)
    with pytest.raises(ValueError, match="tile 100"):
        km.embed_micro(torch.zeros(512, 3), 100)
    with pytest.raises(ValueError, match="square"):
        km.chain_sq(cw, x, 512)
    sq, sx = _chain_case(256, 256, 128)
    with pytest.raises(ValueError, match="n_blocks = 4"):
        km.chain_interleaved(sq, sx, 128, 4)
    for E, W in ((64, 120), (64, 320), (72, 128), (256, 128), (64, 256)):
        with pytest.raises(ValueError, match=f"E = {E}, W = {W}"):
            km.pack_chain([torch.zeros(E, W)] + [torch.zeros(W, W)] * 7)
    args = (8, None, None, None, None)
    assert micro_lib.nefes_micro_chain(0, 500, 128, 1, 64, 128, *args) == -4
    assert micro_lib.nefes_micro_chain(0, 512, 96, 1, 64, 128, *args) == -4
    assert micro_lib.nefes_micro_chain(0, 512, 128, 3, 64, 128, *args) == -4
    assert micro_lib.nefes_micro_chain(0, 512, 128, 4, 256, 256, *args) == -4
    for E, W in ((64, 120), (64, 320), (72, 128), (256, 128), (64, 192),
                 (64, 256)):
        assert micro_lib.nefes_micro_chain(0, 512, 128, 1, E, W, *args) == -4
    assert micro_lib.nefes_micro_chain(0, 512, 128, 1, 64, 128, 0, None,
                                       None, None, None) == -4
    assert micro_lib.nefes_micro_chain(1, 512, 128, 1, 64, 128, *args) == -1
    assert micro_lib.nefes_micro_embed(0, 500, 128, None, None, None) == -4
    assert micro_lib.nefes_micro_embed(1, 512, 128, None, None, None) == -1


def test_grids(micro_lib):
    """The persistent grids of the host build (3 resident CTAs): the chain
    launches the lesser of the units and the resident CTAs; the
    embedding halves a unit while there are fewer than 4 pieces a resident
    CTA."""
    assert micro_lib.nefes_micro_sms() == 3
    assert micro_lib.nefes_micro_chain_grid(0, 512, 64, 1, 64, 128) == 3
    assert micro_lib.nefes_micro_chain_grid(0, 512, 256, 1, 64, 128) == 2
    assert micro_lib.nefes_micro_chain_smem(4, 64, 128) == (
        1024 + 8 * 16384 + 4 * 64 * 64 * 2 + 18 * 8)
    assert micro_lib.nefes_micro_chain_smem(4, 256, 256) == -4
    rows = ctypes.c_int(0)
    for n, tile, grid, piece in ((1024, 64, 3, 64), (1024, 512, 3, 64),
                                 (1024, 1024, 3, 64), (768, 3, 3, 3)):
        assert micro_lib.nefes_micro_embed_grid(0, n, tile,
                                                ctypes.byref(rows)) == grid
        assert rows.value == piece


# --- the commands on the CPU ---

TINY_ARCH = dict(depth=2, width=32, feature_dim=8, skips=(1,))


@pytest.fixture
def cpu_probe(monkeypatch):
    """probe at H, W = 1, 16 (N = 2048) with timeit calling fn once; the
    names timeit was given, in order."""
    names = []

    def once(name, fn, n=10, device="cuda"):
        assert torch.device(device).type == "cpu"
        fn()
        names.append(name)
        return 1e-3
    monkeypatch.setattr(probe, "timeit", once)
    monkeypatch.setattr(probe, "H", 1)
    monkeypatch.setattr(probe, "W", 16)
    return names


def _finite(d: dict) -> bool:
    return all(v is None or isinstance(v, (bool, str)) or math.isfinite(v)
               for v in d.values())


def test_kernelmicro_on_cpu(jax_micro, cpu_probe, tmp_path):
    """Through the CLI: the JAX command's keys, with its per-tile
    full-kernel rows replaced by full_kernel_tile64_ms."""
    out = tmp_path / "micro.json"
    assert probe.main(["kernelmicro", "--device", "cpu", "--tiles", "512",
                       "2048", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = {k for k in jax_micro["keys"] if not k.startswith("full_kernel")}
    assert set(got["results"]) == want | {"full_kernel_tile64_ms"}
    assert _finite(got["results"])
    kinds = {}
    for key, row in got["kernels"].items():
        assert key in got["results"] and _finite(row)
        # no CTA is launched on the CPU; units: N / tile
        assert row["bound_ms"] > 0 and row["blocks"] is None
        assert row["units"] in (JAX_N // 512, JAX_N // 2048,
                                JAX_N // 2 // 512)
        assert (row["library_ms"] is None) == (row["kernel"] == "K11 "
                                               "embed_micro")
        kinds[row["kernel"]] = kinds.get(row["kernel"], 0) + 1
    assert kinds == {"K9 chain": 2, "K10 chain_interleaved": 2,
                     "K11 embed_micro": 2, "K12 chain_sq": 2}
    # K9 at N = 614,400 (H, W = 60, 80): 151.0 GFLOP, bound by operations
    cw = probe.micro_inputs("cpu", 64)["chain"]
    flops, nbytes = probe._chain_work(cw, 614400)
    assert round(flops / 1e9, 1) == 151.0
    ms, by = probe.bound(flops, 0, nbytes)
    assert by == "operations" and round(ms, 4) == 0.1527


def test_kernel_on_cpu(cpu_probe):
    res = probe.cmd_kernel(SimpleNamespace(device="cpu", sweep=True))
    assert _finite(res) and res["kern_fwd_tile64_ms"] == res["kern_fwd_ms"]
    for key in ("static_sigma", "static_rgb", "static_feat"):
        assert res[f"{key}_maxerr_kern16"] < 1e-2
        assert res[f"{key}_maxerr_plain16"] < 1e-2
    assert res["fused_render_rgb_maxerr"] < 1e-2


def test_perf_on_cpu(cpu_probe, monkeypatch):
    monkeypatch.setattr(probe, "H", 2)
    monkeypatch.setattr(probe, "W", 4)
    # a small tower: the command's keys and finiteness do not depend on
    # the width (the card runs the paper architecture)
    monkeypatch.setattr(probe, "ARCH", TINY_ARCH)
    res = probe.cmd_perf(SimpleNamespace(device="cpu", refine_n=1))
    assert len(res) == 7 and _finite(res)
    assert cpu_probe[3] == "50-iter refine"


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_micro_kernels_match_plain_on_card(cuda):
    """bf16 on the tensor cores against the plain versions: relative L2
    1e-2 (summation order; see test_torch_kernels), the embedding bit for
    bit, the interleaved chain equal to the chain at every nb the kernel
    takes (2 and 4 at W = 128, 2 at W = 256)."""
    ins = probe.micro_inputs(cuda, 8192)
    cw, x, pts = ins["chain"], ins["x"], ins["pts"]
    want = km.chain_plain(cw, x)
    for tile in (64, 512, 8192):
        assert _rel_l2(km.chain(cw, x, tile).cpu(), want.cpu()) <= 1e-2
    ref = km.chain(cw, x, 2048)
    for nb in (2, 4):
        assert torch.equal(km.chain_interleaved(cw, x, 2048, nb), ref)
    for tile in (64, 512, 8192):
        assert torch.equal(km.embed_micro(pts, tile),
                           km.embed_micro_plain(pts))
    for w_, (scw, sx) in ins["sq"].items():
        got = km.chain_sq(scw, sx, 512)
        assert _rel_l2(got.cpu(), km.chain_plain(scw, sx).cpu()) <= 1e-2
        for nb in ((2, 4) if w_ == 128 else (2,)):
            assert torch.equal(km.chain_interleaved(scw, sx, 512, nb), got)
    torch.cuda.synchronize()


# --- inscan_ab and profile on the CPU ---

def _jax_dict_keys(fn_name: str, var: str) -> set:
    """The keys of the dict literal assigned to `var` in the JAX probe's
    function fn_name (runtime/probe.py)."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "runtime" / "probe.py")
    fn = next(n for n in ast.walk(ast.parse(src.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == var for t in node.targets):
            return {k.value for k in node.value.keys}
    raise LookupError(f"{fn_name}: no dict assigned to {var}")


@pytest.fixture
def small_refine(monkeypatch):
    """probe at H, W = 8, 8 (mode 2's query 32 x 32), 2 iterations a
    frame, timeit calling fn once; the names timeit was given."""
    names = []

    def once(name, fn, n=10, device="cuda", warm=2):
        t0 = probe.time.perf_counter()
        fn()
        names.append(name)
        return probe.time.perf_counter() - t0
    monkeypatch.setattr(probe, "timeit", once)
    monkeypatch.setattr(probe, "H", 8)
    monkeypatch.setattr(probe, "W", 8)
    monkeypatch.setattr(probe, "ITERS", 2)
    return names


def test_inscan_ab_on_cpu(small_refine, tmp_path, capsys):
    out = tmp_path / "inscan.json"
    assert probe.main(["inscan_ab", "--device", "cpu", "--out",
                       str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got) == _jax_dict_keys("cmd_inscan_ab", "out")
    variants = _jax_dict_keys("cmd_inscan_ab", "variants")
    assert set(got["in_scan_ab_s_per_frame"]) == _jax_dict_keys(
        "cmd_inscan_ab", "results") == {"mode3", "mode2_bf16"}
    for row in got["in_scan_ab_s_per_frame"].values():
        assert set(row) == variants
        assert all(math.isfinite(v) and v > 0 for v in row.values())
    assert len(small_refine) == 8 and all(
        "eager" in n for n in small_refine)
    assert ("inscan_ab: unfused eager, fused_raw eager, fused_pre eager, "
            "render_pre eager") in capsys.readouterr().out


def test_profile_on_cpu(small_refine, tmp_path):
    """The JAX record's keys (PROFILE_r05.json: the report, each leg, a
    top op, a bandwidth floor) and the phases summing to the busy time;
    the field's kernel wrappers in cuda_kernel."""
    out = tmp_path / "profile.json"
    assert probe.main(["profile", "--device", "cpu", "--frames", "1",
                       "--top", "5", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    with open(Path(__file__).resolve().parents[1] / "PROFILE_r05.json") as f:
        want = json.load(f)
    assert set(got) == set(want)
    extra = {"bytes_not_reckoned_ms_per_frame", "ops_attributed_by"}
    for leg in ("mode3", "mode2_bf16"):
        g, w = got[leg], want[leg]
        assert set(g) == set(w) | extra
        assert len(g["top_ops"]) == 5
        assert all(set(t) == set(w["top_ops"][0]) for t in g["top_ops"])
        floor = next(iter(w["phase_bandwidth_floors"].values()))
        assert all(set(f) == set(floor)
                   for f in g["phase_bandwidth_floors"].values())
        assert g["phase_bandwidth_floors"]
        assert _finite_tree(g)
        phases = g["phases_ms_per_frame"]
        assert {"cuda_kernel", "embed", "fusion_net", "sampling+sort",
                "composite"} <= set(phases)
        assert abs(sum(phases.values()) - g["device_busy_ms_per_frame"]) \
            <= 0.05 + 1e-3 * g["device_busy_ms_per_frame"]
        assert set(g["ops_attributed_by"]) <= {"stack", "backward", "none"}
    assert "apr_tower" in got["mode2_bf16"]["phases_ms_per_frame"]


def _finite_tree(x) -> bool:
    if isinstance(x, dict):
        return all(_finite_tree(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite_tree(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True
