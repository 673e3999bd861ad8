"""The port's APR-zoo converters and loader against the reference-layout
replicas and the JAX package, on the CPU in f32.

* Converters (features/convert_backbones.py): the replicas of
  tests/test_backbone_convert.py (torchvision, lukemelas, the EMS
  transformer), random weights and BN statistics: the port's forward
  equals the replica's to 1e-5, and the JAX package's forward after its
  own converters to 1e-5 (of the scale for MS-Transformer). The
  replicas' LayerNorms take flax's eps 1e-6 here, which the port (held to
  the JAX package) uses; the reference layers' 1e-5 is ROADMAP Queue C's
  observation. A synthetic EMSTransPoseNet checkpoint loads with no
  missing or unexpected key.
* Dispatch (features/apr_loader.py): load_apr gives a finite (3, 4) pose
  for every kind, raises for NetVlad, and loads a saved reference
  checkpoint; apr_poses_batched equals the JAX package's vmapped
  apr_pose_any.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from nefes_tpu.features import backbones as jbb
from nefes_tpu.features import convert_backbones as jcb
from nefes_tpu.features import mstransformer as jms
from nefes_tpu.features import posenet as jpn
from nefes_tpu_torch.features import backbones as tbb
from nefes_tpu_torch.features import convert_backbones as tcb
from nefes_tpu_torch.features import mstransformer as tms
from nefes_tpu_torch.features import posenet as tpn
from nefes_tpu_torch.weights import apr_from_jax_variables
from tests.test_backbone_convert import (
    TBranchWrap, TEfficientNet, TMobileNetV2, TResNet34, _randomize_bn,
)
from tests.test_torch_apr_zoo import (  # noqa: F401  (the fixture)
    HW, MEAN, STD, _two_torch_threads, images, jax_variables, within,
)
from tests.torch_parity import close, t


# --- the reference-layout converters ---

class TPoseNetRes34(nn.Module):
    """The reference PoseNet_res34's key layout."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = TResNet34()
        self.feature_extractor.fc = nn.Linear(512, 2048)
        self.fc_pose = nn.Linear(2048, 12)

    def forward(self, x):
        h = self.feature_extractor.fc(self.feature_extractor(x))
        return self.fc_pose(F.relu(h))


class TMapNet(nn.Module):
    """The reference MapNet(PoseNet)'s: mapnet.feature_extractor.*,
    mapnet.fc_xyz / fc_wpqr; forward -> (B, 6) [xyz, logq]."""

    def __init__(self):
        super().__init__()
        self.mapnet = nn.Module()
        self.mapnet.feature_extractor = TResNet34()
        self.mapnet.feature_extractor.fc = nn.Linear(512, 2048)
        self.mapnet.fc_xyz = nn.Linear(2048, 3)
        self.mapnet.fc_wpqr = nn.Linear(2048, 3)

    def forward(self, x):
        m = self.mapnet
        h = F.relu(m.feature_extractor.fc(m.feature_extractor(x)))
        return torch.cat([m.fc_xyz(h), m.fc_wpqr(h)], -1)


class THead(nn.Module):
    """backbone_net + fc_pose (the reference PoseNetV2 and
    EfficientNetB3)."""

    def __init__(self, backbone, width):
        super().__init__()
        self.backbone_net = backbone
        self.fc_pose = nn.Linear(width, 12)

    def forward(self, x):
        return self.fc_pose(self.backbone_net(x))


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


CONVERTERS = {
    # replica, the port's module, converter name, the JAX module, the
    # port's forward on NCHW normalised input
    "resnet34": (TResNet34, tbb.ResNet34, "convert_resnet34",
                 jbb.ResNet34, "backbone"),
    "mobilenet_v2": (TMobileNetV2, tbb.MobileNetV2, "convert_mobilenet_v2",
                     jbb.MobileNetV2, "backbone"),
    "efficientnet_b0": (TEfficientNet, lambda: tbb.EfficientNet("b0"),
                        "convert_efficientnet",
                        lambda: jbb.EfficientNet("b0"), "backbone"),
    "posenet_res34": (TPoseNetRes34, tpn.PoseNetRes34,
                      "convert_posenet_res34", jpn.PoseNetRes34, "apr"),
    "posenet_v2": (lambda: THead(TMobileNetV2(), 1280), tpn.PoseNetV2,
                   "convert_posenet_v2", jpn.PoseNetV2, "apr"),
    "efficientnet_b3_apr": (lambda: THead(TEfficientNet(1.2, 1.4), 1536),
                            tpn.EfficientNetB3APR,
                            "convert_efficientnet_b3_apr",
                            jpn.EfficientNetB3APR, "apr"),
    "mapnet": (TMapNet, tpn.MapNet, "convert_mapnet", jpn.MapNet, "mapnet"),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_matches_replica_and_jax(name):
    rcls, tcls, conv, jcls, kind = CONVERTERS[name]
    torch.manual_seed(0)
    ref = rcls().eval()
    _randomize_bn(ref)
    sd = _sd(ref)
    tmod = tcls(device="cpu") if kind != "backbone" else tcls()
    tmod.load_state_dict(getattr(tcb, conv)(sd))         # strict
    x = np.random.default_rng(10).normal(size=(2, *HW, 3)).astype(np.float32)
    x_img = x * STD + MEAN              # what the APRs normalise back to x
    with torch.no_grad():
        want = ref(t(x).permute(0, 3, 1, 2))
        if kind == "backbone":
            got = tmod(t(x).permute(0, 3, 1, 2))
        elif kind == "mapnet":
            got = tmod.mapnet(t(x_img))
        else:
            got = tmod(t(x_img))
    within(got, want, "port vs replica", rel=1e-5, atol=1e-5)
    jconv = getattr(jcb, conv)({k: v.numpy() for k, v in sd.items()})
    if kind == "backbone":
        jconv = {"params": jconv[0], "batch_stats": jconv[1]}
        jout = jcls().apply(jconv, jnp.asarray(x))
    else:
        jout = jcls().apply(jconv, jnp.asarray(x_img))
        with torch.no_grad():
            got = tmod(t(x_img))
    within(got, jout, "port vs JAX", rel=1e-5, atol=1e-5)


def _ln_eps(module, eps=1e-6):
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.eps = eps
    return module


def test_transformer_branch_converter():
    """nn.MultiheadAttention's packed q/k/v into MHA, the pre-norm DETR
    layers: the replica (LayerNorm eps 1e-6), the port and the JAX
    branch from the same state dict."""
    from nefes_tpu.features.convert_backbones import _branch as jbranch
    d, nhead, layers = 64, 4, 2
    torch.manual_seed(1)
    ref = _ln_eps(TBranchWrap(d, nhead, d, layers).eval())
    sd = {f"X.{k}": v for k, v in _sd(ref).items()}
    out = {}
    tcb._branch(sd, "X", "X", layers, out)
    tmod = tms.TransformerBranch(d, nhead, d, layers)
    tmod.load_state_dict({k[2:]: v for k, v in out.items()})
    rng = np.random.default_rng(5)
    S, B, Q = 12, 2, 3
    src, pos = (rng.normal(size=(S, B, d)).astype(np.float32)
                for _ in range(2))
    query = rng.normal(size=(Q, d)).astype(np.float32)
    with torch.no_grad():
        want = ref(t(src), t(pos), t(query)).transpose(0, 1)   # (B, Q, d)
        got = tmod(t(src).transpose(0, 1), t(pos).transpose(0, 1), t(query))
    within(got, want, "port vs replica", rel=1e-5, atol=1e-5)
    jparams = jbranch({k: v.numpy() for k, v in sd.items()}, "X", layers, d,
                      nhead)
    jout = jms.TransformerBranch(d, nhead, d, layers).apply(
        {"params": jparams}, jnp.asarray(src).transpose(1, 0, 2),
        jnp.asarray(pos).transpose(1, 0, 2), jnp.asarray(query))
    within(got, jout, "port vs JAX", rel=1e-5, atol=1e-5)


def ems_checkpoint(num_scenes=7, d=256, seed=6, layers=6):
    """A synthetic EMSTransPoseNet state dict in the official key layout
    (as tests/test_backbone_convert.py builds one), random BN statistics;
    layers encoder and decoder layers a branch."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
    sd = {}
    bb = TEfficientNet()
    _randomize_bn(bb)
    sd.update({f"backbone.0.body.{k}": v for k, v in _sd(bb).items()})
    sd["backbone.1.row_embed.weight"] = r(50, d // 2)
    sd["backbone.1.col_embed.weight"] = r(50, d // 2)
    for name, cin in (("t", 112), ("rot", 40)):
        sd[f"input_proj_{name}.weight"] = r(d, cin, 1, 1, s=0.02)
        sd[f"input_proj_{name}.bias"] = r(d, s=0.02)
        sd[f"query_embed_{name}.weight"] = r(num_scenes, d)
        br = _ln_eps(TBranchWrap(d, 4, d, layers))
        sd.update({f"transformer_{name}.{k}": v
                   for k, v in _sd(br).items()})
    sd["scene_embed.weight"] = r(1, 2 * d, s=0.02)
    sd["scene_embed.bias"] = r(1, s=0.02)
    for name, out in (("t", 3), ("rot", 4)):
        for s in range(num_scenes):
            p = f"regressor_head_{name}.{s}"
            sd[f"{p}.fc_h.weight"] = r(1024, d, s=0.02)
            sd[f"{p}.fc_h.bias"] = r(1024)
            sd[f"{p}.fc_o.weight"] = r(out, 1024, s=0.02)
            sd[f"{p}.fc_o.bias"] = r(out)
    return sd


def test_mstransformer_checkpoint_loads_and_matches_jax():
    """The full 6 + 6 layers load with no missing or unexpected key; the
    forwards are compared on a 1 + 1-layer checkpoint (the full model's
    forward is held to the JAX package's in test_torch_apr_zoo.py; the
    layers are the same code)."""
    res = tms.MSTransPoseNet(device="cpu").load_state_dict(
        tcb.convert_mstransformer(ems_checkpoint()), strict=False)
    assert res.missing_keys == [] and res.unexpected_keys == []
    sd = ems_checkpoint(layers=1)
    tmod = tms.MSTransPoseNet(layers=1, device="cpu")
    tmod.load_state_dict(tcb.convert_mstransformer(sd, layers=1))
    # the stacked heads: scene s's slice is the reference's head s
    x = np.random.default_rng(7).normal(size=(2, 256)).astype(np.float32)
    head = tmod.regressor_head_t
    for scene in (0, 4):
        got = head(t(x), torch.tensor([scene, scene]))
        p = f"regressor_head_t.{scene}"
        want = F.linear(F.gelu(F.linear(t(x), sd[f"{p}.fc_h.weight"],
                                        sd[f"{p}.fc_h.bias"])),
                        sd[f"{p}.fc_o.weight"], sd[f"{p}.fc_o.bias"])
        close(got.detach(), want, 1e-5, 1e-5, f"scene {scene}")
    jv = jcb.convert_mstransformer({k: v.numpy() for k, v in sd.items()},
                                   layers=1)
    img = images(8, (1, 96, 128))
    want = jax.jit(jms.MSTransPoseNet(layers=1).apply)(jv, jnp.asarray(img))
    with torch.no_grad():
        got = tmod(t(img))
    within(got["pose"], want["pose"], "pose")
    within(got["scene_log_distr"], want["scene_log_distr"], "scenes")


# --- the loader's dispatch ---

KINDS = ["DFNet", "PoseNet", "PoseNetV2", "EfficientNetB3", "MapNet",
         "MsTransformer"]


def _loaded(kind):
    """The JAX module load_apr builds for kind (feature_dim 8;
    MS-Transformer at 1 + 1 layers), seeded variables, and the port's
    module (CPU) holding them."""
    from nefes_tpu.features.dfnet import DFNet as JDFNet
    from nefes_tpu_torch.features import load_apr
    from nefes_tpu_torch.weights import dfnet_from_jax_variables
    jmod = {"DFNet": lambda: JDFNet(output_dim=8),
            "PoseNet": jpn.PoseNetRes34, "PoseNetV2": jpn.PoseNetV2,
            "EfficientNetB3": jpn.EfficientNetB3APR, "MapNet": jpn.MapNet,
            "MsTransformer": lambda: jms.MSTransPoseNet(layers=1)}[kind]()
    v = jax_variables(jmod, images(0, (1, *HW)))
    if kind == "MsTransformer":       # load_apr's, at 1 + 1 layers
        tmod = tms.MSTransPoseNet(layers=1, device="cpu")
    else:
        tmod, _ = load_apr(kind, None, HW, torch.Generator().manual_seed(0),
                           feature_dim=8, device="cpu")
    tmod.load_state_dict(dfnet_from_jax_variables(v) if kind == "DFNet"
                         else apr_from_jax_variables(v))
    return jmod, v, tmod


@pytest.mark.parametrize("kind", KINDS + ["PoseNetRes34"])
def test_load_apr_dispatch(kind):
    from nefes_tpu_torch.features import load_apr
    module, pose_fn = load_apr(kind, None, HW,
                               torch.Generator().manual_seed(0),
                               feature_dim=8, device="cpu")
    with torch.no_grad():
        pose = pose_fn(t(images(11, (1, *HW))[0]))
    assert pose.shape == (3, 4) and torch.isfinite(pose).all()
    if kind == "MsTransformer":             # a unit quaternion's rotation
        R = pose[:, :3]
        close(R @ R.T, np.eye(3), 1e-5, 1e-5)


def test_load_apr_refuses_netvlad():
    from nefes_tpu_torch.features import load_apr
    with pytest.raises(NotImplementedError):
        load_apr("NetVlad", None, HW, torch.Generator(), device="cpu")


def test_load_apr_reads_reference_checkpoint(tmp_path):
    from nefes_tpu_torch.features import load_apr
    torch.manual_seed(2)
    ref = THead(TMobileNetV2(), 1280).eval()
    _randomize_bn(ref)
    path = str(tmp_path / "posenetv2.pt")
    torch.save(ref.state_dict(), path)
    module, pose_fn = load_apr("PoseNetV2", path, HW, torch.Generator(),
                               device="cpu")
    x = images(12, (1, *HW))
    with torch.no_grad():
        want = ref(((t(x) - t(MEAN)) / t(STD)).permute(0, 3, 1, 2))
        got = pose_fn(t(x[0]))
    within(got.reshape(1, 12), want, rel=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_apr_poses_batched_matches_jax(kind):
    from nefes_tpu.refine.apr_opt import apr_pose_any as japr
    from nefes_tpu_torch.refine import apr_poses_batched
    jmod, jvars, tmod = _loaded(kind)
    jvars = jax.tree.map(jnp.asarray, jvars)
    x = images(13, (3, *HW))
    for dataset, pas in (("7Scenes", None), ("Cambridge", np.array(
            [[0.0, -1.0, 0.0, 1.5], [1.0, 0.0, 0.0, -0.5],
             [0.0, 0.0, 1.0, 2.0]], np.float32))):
        if dataset == "Cambridge" and kind != "MsTransformer":
            continue
        want = jax.jit(jax.vmap(lambda im: japr(
            kind, jmod, jvars, im, True, True, dataset,
            None if pas is None else jnp.asarray(pas))))(jnp.asarray(x))
        with torch.no_grad():
            got = apr_poses_batched(kind, tmod, t(x), True, True, dataset,
                                    pas)
        assert got.shape == (3, 3, 4)
        within(got, want, f"{kind} {dataset}")
