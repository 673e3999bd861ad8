"""The port's APR zoo against the JAX package's, on the CPU: backbones
(features/backbones.py), the APR families (posenet.py, mstransformer.py)
and their helpers. The converters and the loader's dispatch are in
tests/test_torch_apr_convert.py.

* Module parity: seeded variables of the JAX modules' layout (random BN
  running statistics) carried into the port by
  weights.apr_from_jax_variables; every backbone and family on running
  statistics in f32: outputs within 1e-5 absolute or 1e-4 of their scale,
  the gradients of a weighted sum of the pose with respect to every
  weight within 1e-4 of each tensor's scale against jax.grad; on batch
  statistics in f64 (BATCH_REL), outputs to 1e-9 and gradients to 1e-6.
  64×80 images (MS-Transformer resizes to 224 anyway); MS-Transformer at
  its full 6 + 6 layers on running statistics, 1 + 1 on batch statistics
  and for its gradients.
* Helpers (quaternions, the exp map, MS-Transformer's output head and
  preprocessing) to 1e-5 on seeded inputs.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features import backbones as jbb
from nefes_tpu.features import mstransformer as jms
from nefes_tpu.features import posenet as jpn
from nefes_tpu_torch.features import backbones as tbb
from nefes_tpu_torch.features import mstransformer as tms
from nefes_tpu_torch.features import posenet as tpn
from nefes_tpu_torch.weights import apr_from_jax_variables
from tests.torch_parity import close, n, t

HW = (64, 80)
# BN on batch statistics is compared in f64 (both packages), to 1e-9 of
# the scale (at least 1e-9 absolute). On the 64x80 images MobileNetV2's
# last stages normalise 12 values a channel, which f32 does not resolve:
# the port read 4.5e-5 and the JAX package (its variance E[x²] - E[x]²)
# 9.3e-5 of the scale from an f64 run, 1.04e-4 from each other; in f64
# the two agree to 1.7e-13 (ROADMAP Queue C). The f32 batch-statistics
# path is held by the refinement tests (tests/test_torch_apr_refine.py).
BATCH_REL = 1e-9
MEAN = np.array(tpn.IMAGENET_MEAN, np.float32)
STD = np.array(tpn.IMAGENET_STD, np.float32)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads a test: the suite runs several workers at once on
    the CPU, and these convolutions gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def within(got, want, msg="", rel=1e-4, atol=1e-5):
    """max |got - want| <= max(atol, rel · max |want|)."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = max(atol, rel * float(np.abs(want).max()))
    assert err <= bound, f"{msg}: max |diff| {err:.3e} > {bound:.3e}"


def images(seed, shape=(2, *HW)):
    return np.random.default_rng(seed).uniform(
        0, 1, (*shape, 3)).astype(np.float32)


def jax_variables(jmod, x, seed=0, **kw):
    """Variables of jmod's layout (jax.eval_shape of its init) as numpy,
    drawn from a seed: kernels N(0, 1/fan-in), biases N(0, 0.1), scales
    U(0.8, 1.2), BN running means N(0, 0.1) and variances U(0.5, 1.5),
    position embeddings U(0, 1), scene queries N(0, 1). Faster than the
    modules' own init and with biases off zero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(partial(jmod.init, **kw), jax.random.key(seed),
                            jnp.asarray(x))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")
              if k in shapes}

    def draw(name, parent, shape):
        if name == "kernel" or name.endswith("_kernel"):
            fan = (shape[0] if name == "kernel" and len(shape) == 3
                   and parent != "out" else
                   shape[-2] if name != "kernel" else
                   int(np.prod(shape[:-1])))
            return rng.normal(0, fan ** -0.5, shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name in ("row_embed", "col_embed"):
            return rng.uniform(0, 1, shape)
        if name.startswith("query_embed"):
            return rng.normal(0, 1, shape)
        return rng.normal(0, 0.1, shape)            # biases, means

    def fill(tree, parent):
        return {k: fill(leaf, k) if isinstance(leaf, dict) else
                draw(k, parent, leaf.shape).astype(np.float32)
                for k, leaf in tree.items()}
    return fill(shapes, "")


def port(tmod, v):
    tmod.load_state_dict(apr_from_jax_variables(v))      # strict
    return tmod


def japply(jmod, v, x, train, **kw):
    """jmod's output, on running or (train) batch statistics, jitted."""
    def run(v, x):
        if train:
            return jmod.apply(v, x, train=True, mutable=["batch_stats"],
                              **kw)[0]
        return jmod.apply(v, x, **kw)
    return jax.jit(run)(v, jnp.asarray(x))


def compare_outputs(jcls, tmod, v, x, train, forward, **kw):
    """(the port's output, the JAX package's) for running statistics in
    f32; for batch statistics in f64, jcls(dtype) and a copy of tmod in
    f64. forward(module, x) runs the port's module on a torch image."""
    if not train:
        with torch.no_grad():
            got = forward(tmod, t(x))
        return got, japply(jcls(jnp.float32), v, x, False, **kw)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        want = jax.tree.map(np.asarray, japply(
            jcls(jnp.float64), v64, np.asarray(x, np.float64), True, **kw))
    with torch.no_grad():
        got = forward(f64_copy(tmod),
                      torch.from_numpy(np.asarray(x, np.float64)))
    return got, want


def f64_copy(tmod):
    """tmod in f64, its ImageNet statistics f64-exact (the buffers hold
    them rounded to f32, which batch statistics amplify to 1e-5)."""
    t64 = copy.deepcopy(tmod).double()
    for m in t64.modules():
        if hasattr(m, "rgb_mean"):
            m.rgb_mean = torch.tensor(tpn.IMAGENET_MEAN, dtype=torch.float64)
            m.rgb_std = torch.tensor(tpn.IMAGENET_STD, dtype=torch.float64)
    return t64


# --- helpers ---

def test_quaternions_match_jax():
    from nefes_tpu.geometry.se3 import quat_to_rotmat as jq2r
    from nefes_tpu.geometry.se3 import rotmat_to_quat as jr2q
    from nefes_tpu_torch.geometry import quat_to_rotmat, rotmat_to_quat
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:8, 0] = 0.0                                  # 180° rotations
    q[8:16] *= 3.0                                  # unnormalised
    close(quat_to_rotmat(t(q)), jq2r(jnp.asarray(q)), 1e-5, 1e-6)
    R = np.asarray(jq2r(jnp.asarray(q)))
    got = rotmat_to_quat(t(R))
    close(got, jr2q(jnp.asarray(R)), 1e-5, 1e-6)
    assert (n(got)[:, 0] >= 0).all()
    close(quat_to_rotmat(got), R, 1e-5, 1e-5, "round trip")


def test_qexp_and_mapnet_pose12_match_jax():
    out6 = np.random.default_rng(2).normal(size=(5, 6)).astype(np.float32)
    out6[0, 3:] = 0.0                               # the exp map at 0
    close(tpn.qexp(t(out6[:, 3:])), jpn.qexp(jnp.asarray(out6[:, 3:])),
          1e-6, 1e-6)
    close(tpn.mapnet_output_to_pose12(t(out6)),
          jpn.mapnet_output_to_pose12(jnp.asarray(out6)), 1e-5, 1e-6)


@pytest.mark.parametrize("dataset", ["7Scenes", "Cambridge"])
def test_ems_pose_to_matrix_matches_jax(dataset):
    rng = np.random.default_rng(3)
    pose7 = rng.normal(size=(3, 7)).astype(np.float32)
    from nefes_tpu.geometry.se3 import quat_to_rotmat as jq2r
    pas = np.concatenate([np.asarray(jq2r(jnp.asarray(rng.normal(size=4)))),
                          rng.normal(0, 2, (3, 1))], axis=1)
    pas[:, :3] *= 1.3                               # not a rigid motion
    want = jms.ems_pose_to_matrix(jnp.asarray(pose7), dataset,
                                  jnp.asarray(pas, jnp.float32))
    got = tms.ems_pose_to_matrix(t(pose7), dataset,
                                 tms.pose_avg_inverse(pas))
    close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 80), (1, 80, 64)],
                         ids=["h_lt_w", "h_gt_w"])
def test_preprocess_mstransformer_matches_jax(shape):
    x = images(4, shape)
    got = tms.preprocess_mstransformer(t(x), t(MEAN), t(STD))
    want = jms.preprocess_mstransformer(jnp.asarray(x))
    assert got.shape == (shape[0], 224, 224, 3)
    close(got, want, 1e-5, 1e-5)


# --- backbones ---

BACKBONES = {      # JAX module of a dtype, the port's, forward options
    "resnet34": (lambda dt: jbb.ResNet34(dtype=dt), tbb.ResNet34, {}),
    "mobilenet_v2": (lambda dt: jbb.MobileNetV2(dtype=dt), tbb.MobileNetV2,
                     {"return_tap": 16}),
    "efficientnet_b0": (lambda dt: jbb.EfficientNet("b0", dtype=dt),
                        lambda: tbb.EfficientNet("b0"),
                        {"return_endpoints": True}),
    "efficientnet_b3": (lambda dt: jbb.EfficientNet("b3", dtype=dt),
                        lambda: tbb.EfficientNet("b3"),
                        {"return_endpoints": True}),
}


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("train", [False, True], ids=["running", "batch"])
@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_jax(name, train):
    jcls, tcls, kw = BACKBONES[name]
    x = images(5)
    v = jax_variables(jcls(jnp.float32), x)
    tmod = port(tcls(), v)
    before = {k: b.clone() for k, b in tmod.state_dict().items()}
    got, want = compare_outputs(
        jcls, tmod, v, x, train,
        lambda m, xt: m(xt.permute(0, 3, 1, 2), train, **kw), **kw)
    for k, b in tmod.state_dict().items():          # running stats untouched
        assert torch.equal(b, before[k]), k
    tol = dict(rel=BATCH_REL, atol=BATCH_REL) if train else {}
    if name == "resnet34":
        within(got, want, name, **tol)
    elif name == "mobilenet_v2":
        within(got[0], want[0], "pooled", **tol)
        within(_nhwc(got[1]), want[1], "tap", **tol)
    else:
        within(_nhwc(got[0]), want[0], "head map", **tol)
        assert set(got[1]) == set(want[1]), (set(got[1]), set(want[1]))
        for k in want[1]:
            within(_nhwc(got[1][k]), want[1][k], k, **tol)


# --- the APR families ---

FAMILIES = {       # JAX module of a dtype, the port's on a device
    "PoseNetRes34": (lambda dt: jpn.PoseNetRes34(dtype=dt),
                     tpn.PoseNetRes34),
    "PoseNetV2": (lambda dt: jpn.PoseNetV2(dtype=dt), tpn.PoseNetV2),
    "EfficientNetB3APR": (lambda dt: jpn.EfficientNetB3APR(dtype=dt),
                          tpn.EfficientNetB3APR),
    "MapNet": (lambda dt: jpn.MapNet(dtype=dt), tpn.MapNet),
    "PoseNetV2Feat": (lambda dt: jpn.PoseNetV2Feat(dtype=dt),
                      tpn.PoseNetV2Feat),
    "EfficientNetB3Feat": (lambda dt: jpn.EfficientNetB3Feat(dtype=dt),
                           tpn.EfficientNetB3Feat),
    "MsTransformer": (lambda dt: jms.MSTransPoseNet(dtype=dt),
                      tms.MSTransPoseNet),
    "MsTransformer1": (lambda dt: jms.MSTransPoseNet(layers=1, dtype=dt),
                       lambda device: tms.MSTransPoseNet(layers=1,
                                                         device=device)),
}


def _family(name, seed=0):
    jcls, tcls = FAMILIES[name]
    x = images(6 + seed)
    v = jax_variables(jcls(jnp.float32), x[:1], seed)
    return jcls, v, port(tcls(device="cpu"), v), x


@pytest.mark.parametrize("name,train", [
    *((name, False) for name in (
        "PoseNetRes34", "PoseNetV2", "EfficientNetB3APR", "MapNet",
        "PoseNetV2Feat", "EfficientNetB3Feat", "MsTransformer")),
    *((name, True) for name in (
        "PoseNetRes34", "PoseNetV2", "EfficientNetB3APR", "MapNet",
        "MsTransformer1"))])
def test_apr_family_matches_jax(name, train):
    """MS-Transformer at its full 6 + 6 layers on running statistics, 1 + 1
    on batch statistics (which reach only its backbone). The feature-tap
    APRs' taps on batch statistics are the backbones' (return_tap,
    return_endpoints in test_backbone_matches_jax)."""
    jcls, v, tmod, x = _family(name)
    got, want = compare_outputs(jcls, tmod, v, x, train,
                                lambda m, xt: m(xt, train))
    tol = dict(rel=BATCH_REL, atol=BATCH_REL) if train else {}
    if name.endswith("Feat"):
        within(got[1], want[1], "pose", **tol)
        assert got[0][0].shape == want[0][0].shape
        within(got[0][0], want[0][0], "features", **tol)
        with torch.no_grad():
            split = tmod(t(x), train, single_stream=False)
        assert split[0][0].shape[:2] == (2, 1)
        assert tmod(t(x), return_feature=False)[0] == []
    elif name.startswith("MsTransformer"):
        within(got["pose"], want["pose"], "pose", **tol)
        within(got["scene_log_distr"], want["scene_log_distr"], "scenes",
               **tol)
        assert torch.equal(got["max_indices"],
                           torch.from_numpy(np.asarray(want["max_indices"])))
    else:
        assert got.shape == (2, 12)
        within(got, want, name, **tol)


@pytest.mark.parametrize("name,train", [
    ("PoseNetRes34", False), ("PoseNetV2", False), ("PoseNetV2", True),
    ("EfficientNetB3APR", False), ("MapNet", False),
    ("MsTransformer1", False)])
def test_apr_family_grads_match_jax(name, train):
    """d Σ w·pose / d weights, every weight, against jax.grad: within 1e-4
    of the tensor's scale, or of 1e-3 of the largest gradient where a
    tensor's own is smaller (weights the pose hardly reaches). On batch
    statistics both run in f64 (BATCH_REL), held to 1e-6: the two read
    5.5e-8 apart there; in f32 the JAX package's gradient stood 7e-3 of
    the scale from the f64 one, the port's 6e-4."""
    jcls, v, tmod, x = _family(name, seed=1)
    x = x[:1]
    w = np.random.default_rng(9).normal(size=(1, 12 if name != "MsTransformer1"
                                              else 7))
    dt = jnp.float64 if train else jnp.float32

    def pose_of(out):
        return out["pose"] if isinstance(out, dict) else out

    with jax.enable_x64(train):
        jmod = jcls(dt)
        vj = jax.tree.map(lambda a: jnp.asarray(a, dt), v)
        xj = np.asarray(x, dt)

        def jloss(params):
            out = japply(jmod, {**vj, "params": params}, xj, train)
            return jnp.sum(pose_of(out) * w.astype(dt))
        jg = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
            vj["params"]))
    want = apr_from_jax_variables({"params": jg})
    if train:
        tmod = f64_copy(tmod)
        want = {k: g.double() for k, g in want.items()}
    xt = torch.from_numpy(np.asarray(x, np.float64 if train else np.float32))
    tmod.zero_grad()
    (pose_of(tmod(xt, train)) * torch.from_numpy(w).to(xt.dtype)).sum(
        ).backward()
    got = dict(tmod.named_parameters())
    assert set(got) == set(want)
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    rel = 1e-6 if train else 1e-4
    for k, p in got.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        within(g, want[k], k, rel=rel, atol=rel * floor)
