"""The bf16 DFNet of mode 2 (--apr_compute_dtype bfloat16) against the
JAX package's DFNet(dtype=bfloat16), on the CPU, and the port's probe
command mode2 at a tiny size.

The two bf16 DFNets convolve in bf16 with f32 accumulation in different
libraries (oneDNN, XLA), so single roundings part; they are held to each
other by relative L2, ||port - JAX|| / ||JAX||, on the three feature
levels and the pose: at most 1e-2, and at most the larger of the two
packages' own f32-vs-bf16 gaps (each printed beside). Read at this seed
(64x80, running BN): levels 3.0e-4 / 3.1e-3 / 1.3e-3 and pose 2.7e-3
against JAX's gaps 5.8e-3 / 7.2e-3 / 2.0e-3 / 2.8e-3; on batch BN
statistics levels 4.0e-4 / 6.2e-3 / 7.0e-3 against 6.7e-3 / 1.1e-2 /
1.0e-2.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features.dfnet import DFNet as JDFNet
from nefes_tpu_torch.features.dfnet import DFNet
from nefes_tpu_torch.runtime import probe
from nefes_tpu_torch.weights import dfnet_from_jax_variables

RNG = np.random.default_rng(18)
IMG_HW = (64, 80)
TOL = 1e-2


def _rl2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def dfnet_runs():
    """{(train_bn, dtype): (JAX features, JAX pose, port features, port
    pose)} of one set of weights (random BN statistics) on one image."""
    image = RNG.uniform(0, 1, IMG_HW + (3,)).astype(np.float32)
    v = jax.tree.map(np.asarray, JDFNet(output_dim=8).init(
        jax.random.key(0), image[None]))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    for blk in v["batch_stats"].values():
        blk["bn"]["mean"] = RNG.normal(0, 0.1, blk["bn"]["mean"].shape)
        blk["bn"]["var"] = RNG.uniform(0.5, 1.5, blk["bn"]["var"].shape)
    v = jax.tree.map(lambda x: np.asarray(x, np.float32), v)
    runs = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JDFNet(output_dim=8, dtype=jdt)
        tm = DFNet(output_dim=8, dtype=tdt, device="cpu")
        tm.load_state_dict(dfnet_from_jax_variables(v))
        for train_bn in (False, True):
            kw = dict(upsample_hw=IMG_HW, train_bn=train_bn)
            if train_bn:
                (jf, jp), _ = jm.apply(v, jnp.asarray(image)[None],
                                       mutable=["batch_stats"], **kw)
            else:
                jf, jp = jm.apply(v, jnp.asarray(image)[None], **kw)
            with torch.no_grad():
                tf, tp = tm(torch.from_numpy(image)[None], **kw)
            runs[(train_bn, name)] = (
                np.asarray(jf.astype(jnp.float32)), np.asarray(jp),
                tf.float().numpy(), tp.float().numpy())
            # the features come out f32 in both (the f32 resize matrix
            # promotes them), the pose from the f32 head
            assert jf.dtype == jnp.float32 and tf.dtype == torch.float32
    return runs


@pytest.mark.parametrize("train_bn", [False, True],
                         ids=["running_bn", "batch_bn"])
def test_bf16_dfnet_matches_jax(dfnet_runs, train_bn):
    jf32, jp32, tf32, tp32 = dfnet_runs[(train_bn, "f32")]
    jb, jpb, tb, tpb = dfnet_runs[(train_bn, "bf16")]
    pairs = [(f"level {lv}", tb[lv], jb[lv], jf32[lv], tf32[lv])
             for lv in range(3)] + [("pose", tpb, jpb, jp32, tp32)]
    for what, port, jax_b, jax_f, port_f in pairs:
        gap = _rl2(port, jax_b)
        jgap, tgap = _rl2(jax_b, jax_f), _rl2(port, port_f)
        print(f"{what}: port vs JAX bf16 {gap:.2e}; f32 vs bf16: JAX "
              f"{jgap:.2e}, port {tgap:.2e}")
        assert gap <= TOL and gap <= max(jgap, tgap), (what, gap, jgap,
                                                        tgap)
        # bf16 did round: the f32 and bf16 runs differ in both packages
        assert jgap > 1e-5 and tgap > 1e-5


def test_mode2_probe_on_cpu(monkeypatch):
    """The probe's mode2 command at a 8x8 render (a 32x32 query), 2
    iterations: f32 and bf16 DFNet each time in turns and leave a finite
    final loss."""
    monkeypatch.setattr(probe, "H", 8)
    monkeypatch.setattr(probe, "W", 8)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = probe.cmd_mode2(SimpleNamespace(device="cpu", iters=2))
    finally:
        torch.set_num_threads(n)
    assert set(res) == {"f32_s_per_frame", "f32_final_loss",
                        "bf16_s_per_frame", "bf16_final_loss"}
    assert all(math.isfinite(v) and v > 0 for v in res.values())
    assert res["f32_final_loss"] != res["bf16_final_loss"]
