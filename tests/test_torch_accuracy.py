"""The probe's accuracy pipeline in the port (nefes_tpu_torch/runtime/
accuracy.py, probe.py's cmd_accuracy) against the JAX package's
runtime/probe.py cmd_accuracy, on the CPU:

  - the contrastive DFNet loss and its gradient over the trainable groups,
    against the JAX package's extract_target_features and
    feature_cosine_loss composed as probe.py:658-675 composes them, in one
    jax.jit (64x64 images, B = 2 triplets, S = 2 negatives): the value to
    1e-5 relative, each gradient (in f64) to 1e-4 of its largest entry;
  - the augmented APR loss (:840-852) with the jitter and noise given as
    arrays, to 1e-5;
  - the APR's AdamW under a cosine decay and the finetuning Adam, 5 steps
    of a fixed gradient sequence, against optax to 1e-6;
  - the summary statistics on hand-built arrays;
  - one whole run of the command (--device cpu) at full width, 64x64
    images, 4 training views, 2 test frames, one epoch a stage, one
    feature step (one negative scale), two APR steps, one refine and one
    mode-3 lr, two iterations: the JAX command's keys, every number
    finite, the JSON written; a second run from its --cache trains
    nothing and gives the same result.

The whole run dominates the file's time: at full width the kernels'
plain versions (bf16 products emulated in f32) take seconds a 64x64
render and tens of seconds the stage-2 patch step's 7,168 rays.
"""

import json
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefes_tpu.features.dfnet import DFNet as JDFNet
from nefes_tpu.features.dfnet import extract_target_features as jextract
from nefes_tpu.refine.losses import feature_cosine_loss as jfcl
from nefes_tpu_torch.features.dfnet import (
    IMAGENET_MEAN, IMAGENET_STD, DFNet,
)
from nefes_tpu_torch.runtime import accuracy as acc
from nefes_tpu_torch.runtime import probe
from nefes_tpu_torch.train.trainer import Adam
from nefes_tpu_torch.utils.init import lecun_normal_
from nefes_tpu_torch.weights import dfnet_from_jax_variables

RNG = np.random.default_rng(23)
HW, B, S, OUT_DIM, MARGIN = (64, 64), 2, 2, 8, 0.3


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _to_jax_variables(sd: dict) -> dict:
    """The port's DFNet state dict -> the JAX DFNet's variables (numpy),
    the inverse of weights.dfnet_from_jax_variables."""
    params, stats = {}, {}
    for name in acc.DFNET_GROUPS:
        if name == "fc_pose":
            params[name] = {"kernel": sd["fc_pose.weight"].numpy().T,
                            "bias": sd["fc_pose.bias"].numpy()}
        elif name.startswith("adapt"):
            params[name] = {c: {"kernel": sd[f"{name}.{c}.weight"].permute(
                2, 3, 1, 0).numpy(), "bias": sd[f"{name}.{c}.bias"].numpy()}
                for c in ("conv1", "conv2")}
            params[name]["bn"] = {"scale": sd[f"{name}.bn.weight"].numpy(),
                                  "bias": sd[f"{name}.bn.bias"].numpy()}
            stats[name] = {"bn": {"mean": sd[f"{name}.bn.running_mean"]
                                  .numpy(),
                                  "var": sd[f"{name}.bn.running_var"].numpy()}}
        else:
            params[name] = {"kernel": sd[f"{name}.weight"].permute(
                2, 3, 1, 0).numpy(), "bias": sd[f"{name}.bias"].numpy()}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def dfnets():
    """(JAX DFNet, its variables as numpy, the port's DFNet on the CPU with
    the same weights), f32: the port's seeded weights carried to JAX (and
    back through dfnet_from_jax_variables, bit for bit)."""
    tm = DFNet(output_dim=OUT_DIM, device="cpu",
               generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for blk in (tm.adapt_0, tm.adapt_1, tm.adapt_2):
            blk.bn.running_mean.normal_(0, 0.1)
            blk.bn.running_var.uniform_(0.5, 1.5)
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    v = _to_jax_variables(sd)
    back = dfnet_from_jax_variables(v)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    return JDFNet(output_dim=OUT_DIM), v, tm


def _images(*lead):
    return RNG.uniform(0, 1, (*lead, *HW, 3)).astype(np.float32)


def _jax_contrastive(jm, v, dt, fh, fw):
    """The JAX command's ft_step loss (probe.py:658-675) as a function of
    the trainable parameters and the triplets, v's weights cast to dt."""
    cast = partial(jax.tree.map, lambda x: jnp.asarray(x, dt))
    params, bstats = cast(v["params"]), cast(v["batch_stats"])
    tr_keys = [k for k in params if k != "fc_pose"]
    frozen = {k: x for k, x in params.items() if k not in tr_keys}

    def lf(fp, imgs_b, pos_b, neg_b):
        vv = {"params": {**frozen, **fp}, "batch_stats": bstats}
        Bb, Ss = neg_b.shape[0], neg_b.shape[1]
        allimg = jnp.concatenate(
            [imgs_b, pos_b, neg_b.reshape((Bb * Ss,) + neg_b.shape[2:])])
        f = jextract(jm, vv, allimg, fh, fw)
        f_real, f_pos = f[:Bb], f[Bb:2 * Bb]
        f_neg = f[2 * Bb:].reshape((Bb, Ss) + f.shape[1:])
        p_l = jax.vmap(jfcl)(f_real, f_pos)
        n_l = jax.vmap(lambda fr, ns: jax.vmap(
            lambda n: jfcl(fr, n))(ns))(f_real, f_neg)
        hinge = jnp.maximum(0.0, MARGIN + p_l - jnp.min(n_l, axis=1))
        return p_l.mean() + hinge.mean()
    return lf, {k: params[k] for k in tr_keys}


def _f64_copy(tm):
    """tm in f64, its ImageNet statistics f64-exact."""
    t64 = DFNet(output_dim=OUT_DIM, dtype=torch.float64, device="cpu")
    t64.load_state_dict(tm.state_dict())
    t64.double()
    t64.rgb_mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64)
    t64.rgb_std = torch.tensor(IMAGENET_STD, dtype=torch.float64)
    return t64


def test_contrastive_loss_and_grad_match_jax(dfnets):
    """The port's f32 loss against JAX's in f64 (JAX under enable_x64),
    the gradient over every trainable group with the port's DFNet in f64
    too: on the JAX DFNet's own initial weights each package's f32
    gradient of conv1_1 stood 8e-4 of its scale from the f64 one, so f32
    need not resolve 1e-4 (in f64 the two read 4.6e-8 apart here). A
    gradient within 1e-4 of its tensor's largest entry, or of 1e-3 of the
    largest gradient where the tensor's own is smaller (the BN scales': 0
    but for rounding, the per-channel cosine being blind to a channel's
    scale)."""
    _, v, tm = dfnets
    imgs = _images(B)
    pos = np.clip(imgs + RNG.normal(0, 0.05, imgs.shape), 0, 1)
    neg = np.clip(imgs[:, None] + RNG.normal(0, 0.2, (B, S, *HW, 3)), 0, 1)
    pos, neg = pos.astype(np.float32), neg.astype(np.float32)
    fh, fw = HW[0] // 2, HW[1] // 2
    with jax.enable_x64(True):
        lf64, fp64 = _jax_contrastive(JDFNet(output_dim=OUT_DIM,
                                             dtype=jnp.float64), v,
                                      jnp.float64, fh, fw)
        jl, jg = jax.jit(jax.value_and_grad(lf64))(
            fp64, *(x.astype(np.float64) for x in (imgs, pos, neg)))
        jl, jg = float(jl), jax.tree.map(np.asarray, jg)
    with torch.no_grad():
        tl = acc.contrastive_loss(tm, torch.from_numpy(imgs),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(neg), fh, fw, MARGIN)
    # the hinge is active, so both terms reach the gradient
    assert jl > 0.05
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)

    groups = acc.trainable_groups("all")
    assert set(groups) == set(fp64)
    t64 = _f64_copy(tm)
    t64.requires_grad_(False)
    params = {n: p for n, p in t64.named_parameters()
              if n.split(".")[0] in groups}
    for p in params.values():
        p.requires_grad_(True)
    acc.contrastive_loss(t64, *(torch.from_numpy(x.astype(np.float64))
                                for x in (imgs, pos, neg)),
                         fh, fw, MARGIN).backward()
    zeros = jax.tree.map(np.zeros_like, v["params"])
    want = dfnet_from_jax_variables({"params": {**zeros, **jg},
                                     "batch_stats": v["batch_stats"]})
    floor = 1e-3 * max(float(want[n].abs().max()) for n in params)
    reached = 0
    for name, p in params.items():
        w = want[name].double().numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(w).max(), floor)
        reached += np.abs(w).max() > floor
        assert np.abs(g - w).max() <= 1e-4 * scale, (name, scale)
    # level 0 only: conv1_1, conv1_2 and adapt_0 take gradients
    assert reached >= 7


def test_apr_loss_matches_jax(dfnets):
    jm, v, tm = dfnets
    imgs = _images(B)
    gt12 = RNG.normal(0, 1, (B, 12)).astype(np.float32)
    scale = RNG.uniform(*acc.JITTER, (B, 1, 1, 1)).astype(np.float32)
    noise = RNG.normal(0, 1, imgs.shape).astype(np.float32)
    jimgs = jnp.clip(imgs * scale + 0.005 * noise, 0.0, 1.0)
    _, pose12 = jm.apply(v, jimgs, return_feature=False, return_pose=True)
    want = float(jnp.mean((pose12 - gt12) ** 2))
    with torch.no_grad():
        got = acc.apr_loss(tm, *(torch.from_numpy(x) for x in (
            imgs, gt12, scale, noise))).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind,weight_decay", [
    ("adamw_cosine", 1e-4), ("adamw_cosine", 0.5), ("adam", 0.0)])
def test_optimizers_match_optax(kind, weight_decay):
    """5 steps of one gradient sequence (b's gradient missing at step 2:
    optax sees zeros) against optax.adamw(cosine_decay_schedule) and
    optax.adam; decay_steps 4 < 5 steps reaches the schedule's floor."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    seq = [{k: rng.normal(size=x.shape).astype(np.float32)
            for k, x in p0.items()} for _ in range(5)]
    lr = 1e-2
    if kind == "adam":
        tx = optax.adam(lr)
    else:
        tx = optax.adamw(optax.cosine_decay_schedule(lr, 4, alpha=0.02),
                         weight_decay=weight_decay)
    jp, st = jax.tree.map(jnp.asarray, p0), None
    st = tx.init(jp)
    tp = {k: torch.from_numpy(x.copy()) for k, x in p0.items()}
    opt = (Adam(tp.values()) if kind == "adam" else acc.AdamW(
        tp.values(), acc.cosine_decay_schedule(lr, 4, 0.02), weight_decay))
    for i, g in enumerate(seq):
        if i == 2:
            g = {**g, "b": np.zeros_like(g["b"])}
        up, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            p.grad = (None if (i == 2 and k == "b")
                      else torch.from_numpy(g[k]))
        opt.step(lr) if kind == "adam" else opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kind} step {i} {k}")


def test_cosine_decay_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(2e-4, 10, alpha=0.02)
    ours = acc.cosine_decay_schedule(2e-4, 10, 0.02)
    for c in (0, 1, 5, 9, 10, 15):
        np.testing.assert_allclose(ours(c), float(sched(c)), rtol=1e-6)


def test_lecun_normal_matches_flax():
    """utils/init.py's lecun_normal_ against flax's lecun_normal: the std
    of a weight's entries 1 / sqrt(fan_in) (a conv's fan_in its inputs
    times its kernel's area), truncated at 2 of the normal's std, the
    biases 0; a seed fixes the draw."""
    lin, conv = torch.nn.Linear(512, 256), torch.nn.Conv2d(64, 128, 3)
    lecun_normal_(torch.nn.Sequential(lin, conv),
                  torch.Generator().manual_seed(0))
    for mod, fan_in in ((lin, 512), (conv, 64 * 9)):
        jw = np.asarray(jax.nn.initializers.lecun_normal()(
            jax.random.key(0), (fan_in, 4096)))
        w = mod.weight.detach().numpy()
        np.testing.assert_allclose(w.std(), fan_in ** -0.5, rtol=0.02)
        np.testing.assert_allclose(w.std(), jw.std(), rtol=0.02)
        assert np.abs(w).max() <= np.abs(jw).max() * 1.001
        assert not mod.bias.detach().any()
    again = torch.nn.Linear(512, 256)
    lecun_normal_(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, lin.weight)


# --- the summaries, on hand-built arrays ---

def test_split_views():
    train, test = acc.split_views(60, 32)
    assert list(test[:3]) == [2, 4, 6] and test[-1] == 64 and len(test) == 32
    assert len(train) == 60 and not set(train) & set(test)
    assert list(train[:4]) == [0, 1, 3, 5]
    train, test = acc.split_views(4, 2)
    assert list(test) == [2, 5] and list(train) == [0, 1, 3, 4]


def test_relief_and_landscape():
    at_init = np.array([[0.5, 0.30, 0.40], [0.4, 0.20, 0.45],
                        [0.3, 0.25, 0.50]])
    at_gt = np.array([[0.2, 0.35, 0.10], [0.3, 0.10, 0.60],
                      [0.1, 0.30, 0.20]])
    assert acc.relief(at_init, at_gt, 0) == 50.0        # (0.4-0.2)/0.4
    assert acc.relief(at_init, at_gt, 1) == -20.0       # (0.25-0.3)/0.25
    land = acc.landscape_summary(at_init, at_gt)
    assert list(land) == [
        "dfm_loss_at_init_fused", "dfm_loss_at_gt_fused",
        "dfm_loss_at_init_raw", "dfm_loss_at_gt_raw",
        "dfm_loss_at_init_fused_running", "dfm_loss_at_gt_fused_running",
        "dfm_relief_raw_pct", "dfm_relief_fused_running_pct",
        "frames_gt_lower_fused_frac", "frames_gt_lower_raw_frac"]
    assert land["dfm_loss_at_gt_fused_running"] == 0.2
    assert land["dfm_relief_fused_running_pct"] == 55.56  # (.45-.2)/.45
    assert land["frames_gt_lower_fused_frac"] == 1.0
    assert land["frames_gt_lower_raw_frac"] == pytest.approx(1 / 3)


def _poses_at(ts):
    """(N, 3, 4) identity rotations at translations (t, 0, 0)."""
    p = np.tile(np.eye(4)[:3], (len(ts), 1, 1))
    p[:, 0, 3] = ts
    return p


def test_verification_confusion():
    err_init = np.array([[1.0, 0], [1.0, 0], [1.0, 0], [1.0, 0]])
    err_ref = np.array([[2.0, 0], [0.5, 0], [2.0, 0], [0.5, 0]])
    retreated = np.array([True, True, False, False])
    conf, degraded = acc.verification_confusion(err_init, err_ref, retreated)
    assert list(degraded) == [True, False, True, False]
    assert conf == {"degraded_frames": 2, "retreat_true_positive": 1,
                    "retreat_miss": 1, "retreat_false_positive": 1,
                    "proxy_miss_rate": 0.5}


def test_proxy_comparison():
    gt = _poses_at([0.0] * 4)
    init = _poses_at([1.0] * 4)
    refined = _poses_at([2.0, 0.5, 2.0, 0.5])
    err_init = np.array([[1.0, 0.0]] * 4)
    degraded = np.array([True, False, True, False])
    retreated = np.array([True, True, False, False])
    losses = np.array([[1.0, 2.0], [1.0, 0.5], [1.0, 0.5], [1.0, 2.0]])
    out = acc.proxy_comparison(losses, retreated, degraded, init, refined,
                               gt, err_init)
    common = {"median_t_m": 1.0, "median_r_deg": 0.0,
              "frames_worse_than_init": 1}
    assert out == {
        "psnr_ssim": {"retreats": 2, "true_positive": 1, "miss": 1,
                      "false_positive": 1, **common},
        "dfm": {"retreats": 2, "true_positive": 1, "miss": 1,
                "false_positive": 1, **common},
        "either": {"retreats": 3, "true_positive": 1, "miss": 1,
                   "false_positive": 2, **common}}


def test_best_mode3():
    runs = [{"lr_r": 1, "median_t_m": 0.8, "median_r_deg": 2.2},
            {"lr_r": 2, "median_t_m": 0.9, "median_r_deg": 1.5},
            {"lr_r": 3, "median_t_m": 0.7, "median_r_deg": 2.6}]
    # summed relative gains over (1, 2): 0.1, 0.35, 0.0
    assert acc.best_mode3(runs, 1.0, 2.0)["lr_r"] == 2


def test_collapse_guard_resets_fusion():
    """A FusionNet whose second conv's ReLUs are all dead reads 0 live
    there (the guard's trigger, < 1 %); reset_fusion draws its convs from
    seed 17 with flax's initialisers (biases 0) and resets its BN: live
    again."""
    from nefes_tpu_torch.train.diagnostics import fusion_conv_liveness
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    cfg = ModelConfig(feature_dim=16)
    model = NeFeSModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    rgb = torch.rand((12, 16, 3), generator=torch.Generator().manual_seed(1))
    feat = torch.randn((12, 16, 16),
                       generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.fusion.conv1.weight.zero_()
        model.fusion.conv1.bias.fill_(-1.0)
        model.fusion.bn.running_var.fill_(1e-10)
    live = fusion_conv_liveness(model.fusion, rgb, feat)
    assert live["conv1"] == 0.0 and any(v < 0.01 for v in live.values())
    acc.reset_fusion(model, 17)
    fresh = NeFeSModel(cfg, device="cpu").fusion
    lecun_normal_(fresh, torch.Generator().manual_seed(17))
    for (k, a), b in zip(model.fusion.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert not model.fusion.conv1.bias.detach().any()
    assert all(v >= 0.01 for v in fusion_conv_liveness(
        model.fusion, rgb, feat).values())


# --- the whole command ---

# the JAX command's result keys (runtime/probe.py:1160-1220), nested
_SUB = {"lr", "median_t_m", "median_r_deg", "improved_frames_frac"}
_PROXY = {"retreats", "true_positive", "miss", "false_positive",
          "median_t_m", "median_r_deg", "frames_worse_than_init"}
JAX_KEYS = [
    "pipeline", "image_hw", "n_train_views", "field", "opt_iter", "frames",
    "per_pixel_dfm", "train_psnr_db", "refine_lr",
    "feat_cos_loss_fused_renderscale",
    "feat_cos_loss_fused_running_renderscale",
    "feat_cos_loss_raw_renderscale", "headline_fusion_bn",
    "fusion_beats_raw_at_dfm_scale", "fusion_relief_beats_raw",
    "fusion_ablation", "fusion_beats_raw_final_medians",
    "median_t_before_m", "median_t_after_m", "median_r_before_deg",
    "median_r_after_deg", "median_t_after_no_verif_m",
    "median_r_after_no_verif_deg", "retreat_frames",
    "frames_worse_after_verification", "verification_confusion",
    "proxy_comparison", "improved_frames_frac", "dfm_relief_fused_pct",
    "mode3_median_t_after_m", "mode3_median_r_after_deg",
    "mode3_median_t_before_m", "mode3_median_r_before_deg",
    "mode3_improved_frames_frac", "mode3_improved_rot_frames_frac",
    "mode3_lr_r", "mode3_lr_t", "mode3_lr_r_sweep", "mode3_note",
    "dfm_loss_at_init_fused", "dfm_loss_at_gt_fused",
    "dfm_loss_at_init_raw", "dfm_loss_at_gt_raw",
    "dfm_loss_at_init_fused_running", "dfm_loss_at_gt_fused_running",
    "dfm_relief_raw_pct", "dfm_relief_fused_running_pct",
    "frames_gt_lower_fused_frac", "frames_gt_lower_raw_frac",
    "fusion_liveness", "fusion_collapse_retry", "fusion_bn_calibration",
    "grad_clip", "texture_amp", "texture_freq", "wall_s", "device",
    "t_improvement_x", "r_improvement_x"]
JAX_NESTED = {
    "fusion_ablation": {"fused_batch": _SUB, "raw": _SUB,
                        "fused_running": _SUB},
    "verification_confusion": {"degraded_frames", "retreat_true_positive",
                               "retreat_miss", "retreat_false_positive",
                               "proxy_miss_rate"},
    "proxy_comparison": {"psnr_ssim": _PROXY, "dfm": _PROXY,
                         "either": _PROXY},
    "fusion_liveness": {"conv0", "conv1", "conv2"},
    "fusion_bn_calibration": {"corr_median", "corr_frac_gt_0p5", "l1_post",
                              "scale_median", "bias_range", "views",
                              "feat_cos_fused_precal",
                              "feat_cos_fused_running_precal"},
}
MODE3_RUN_KEYS = {"lr_r", "lr_t", "median_t_m", "median_r_deg",
                  "improved_t_frac", "improved_r_frac"}
TINY_ARCH = dict(depth=2, width=32, feature_dim=8, skips=(1,))
SMALL = ["accuracy", "--device", "cpu", "--image_h", "64", "--image_w",
         "64", "--n_train", "4", "--n_test", "2", "--epochs_color", "1",
         "--epochs_feat", "1", "--epochs_fusion", "1", "--feat_steps", "1",
         "--apr_steps", "2", "--refine_lrs", "4e-6", "--mode3_lr_r", "0.002",
         "--opt_iter", "2", "--neg_scales", "1.0"]


def _numbers(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _numbers(v, f"{path}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield path, x


@pytest.fixture(scope="module")
def whole_run(tmp_path_factory):
    """The command at the small size, from nothing, with a --cache: (its
    JSON, the cache path, the out path)."""
    d = tmp_path_factory.mktemp("accuracy")
    cache, out = str(d / "cache.pt"), str(d / "out.json")
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        # a small tower: the keys, finiteness and the cache do not depend
        # on the width (the card runs the paper architecture)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(probe, "ARCH", TINY_ARCH)
            assert probe.main(SMALL + ["--cache", cache, "--out", out]) == 0
    finally:
        torch.set_num_threads(n)
    with open(out) as f:
        return json.load(f), cache, out


def test_accuracy_command_keys_and_finite(whole_run):
    res, _, _ = whole_run
    assert list(res) == JAX_KEYS
    for key, sub in JAX_NESTED.items():
        if isinstance(sub, dict):
            assert set(res[key]) == set(sub), key
            for k, s in sub.items():
                assert set(res[key][k]) == s, (key, k)
        else:
            assert set(res[key]) == sub, key
    assert [set(r) for r in res["mode3_lr_r_sweep"]] == [MODE3_RUN_KEYS]
    bad = [p for p, x in _numbers(res) if not math.isfinite(x)]
    assert not bad, bad
    assert res["device"] == "cpu" and res["image_hw"] == [64, 64]
    assert res["frames"] == 2 and res["opt_iter"] == 2
    assert res["n_train_views"] == 4 and res["refine_lr"] == 4e-6


def test_accuracy_command_from_cache(whole_run, monkeypatch):
    """A second run from the first one's cache trains nothing (the
    stages, the finetuning and the APR are refused here) and gives the
    same result but the wall time."""
    res, cache, out = whole_run
    saved = torch.load(cache)
    assert {"variables", "dfvars_params", "s0_variables", "train_psnr",
            "apr_params"} <= set(saved)

    def refuse(*a, **k):
        raise AssertionError("trained again despite the cache")
    for name in ("run_stages", "finetune_dfnet", "train_apr",
                 "render_contrastive_set"):
        monkeypatch.setattr(acc, name, refuse)
    out2 = out.replace("out.json", "out2.json")
    monkeypatch.setattr(probe, "ARCH", TINY_ARCH)
    assert probe.main(SMALL + ["--cache", cache, "--out", out2]) == 0
    with open(out2) as f:
        res2 = json.load(f)
    assert {k: v for k, v in res2.items() if k != "wall_s"} \
        == {k: v for k, v in res.items() if k != "wall_s"}
