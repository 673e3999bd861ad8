"""The field zoo in training (nefes_tpu_torch/train/field_zoo.py through
train/trainer.py and render/validation.py) against the JAX package's, on
the CPU in f32 at tests/test_field_zoo.py's sizes (depth 2, width 16,
hash_level 3, bound 2, N_vocab 128, 4 histogram bins), perturb off, the
JAX weights carried across with weights.zoo_from_jax_variables.

1. The latents: the N_vocab lookup of a histogram, one image's and a
   batch's, every ray of the port's one-pass render its image's.
2. For each kind (nerfw, nerf, hash): one random-ray step at given
   pixels, the port rendering all B·N rays in one field pass, against
   JAX value_and_grad of its per-image _render_selected -> _finalize_rgb
   -> nefes_training_loss; and one patch step at given crop corners (the
   zoo has no feature head or FusionNet, so the port's patch step is the
   colour loss on the patches' pixels), against the same JAX pieces at
   the patches' pixels. Loss to 1e-5 relative, every gradient (the
   N_vocab tables' and the hash tables' included) to 1e-4 of its largest
   entry, the parameters after one Adam step to 1e-3 of the learning
   rate where the gradient exceeds 1e-6, else to 2 learning rates
   (tests/test_torch_train.py's reasoning: Adam's first step moves a
   weight by lr·g / (|g| + 1e-8), and the hash tables' rows and dead
   units hold gradients near 1e-8).
3. --l1normloss on the hash field: the term and its table gradients
   against the JAX aux_regularizers, and a train step's loss rises with
   it; refused for the other kinds.
4. A validation render (render_path) of the NeRF-W field with each
   view's latents, frames to 1e-5, and a checkpoint round trip.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefes_tpu.fields.embedder import EmbedConfig as JEmbed
from nefes_tpu.render.validation import render_path as jrender_path
from nefes_tpu.train import field_zoo as jzoo
from nefes_tpu.train import losses as jlosses
from nefes_tpu.train import trainer as jtrainer
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.fields.embedder import EmbedConfig as TEmbed
from nefes_tpu_torch.render.validation import render_path
from nefes_tpu_torch.train import (
    AuxConfig, create_train_state, latest_checkpoint, patch_loss, rays_loss,
    restore_checkpoint, save_checkpoint, train_step_rays,
)
from nefes_tpu_torch.train import field_zoo as tzoo
from nefes_tpu_torch.train.trainer import (
    CROP_SIZE, NUM_CROPS, aux_regularizers, apply_gradients,
)
from nefes_tpu_torch.weights import zoo_from_jax_variables
from tests.torch_parity import close, n, t

RNG = np.random.default_rng(161)
H, W, FOCAL, NEAR, FAR = 20, 24, 18.0, 0.5, 4.0
B, N_PIX, LR, BINS = 2, 16, 1e-3, 4
KINDS = ("nerfw", "nerf", "hash")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of tiny ops a step: one torch thread each runs them at
    full speed while the suite's workers share the CPU."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _cfgs(kind):
    common = dict(kind=kind, depth=2, width=16, skips=(1,), hash_level=3,
                  bound=2.0, n_vocab=128, hist_bin=BINS)
    return (jzoo.ZooConfig(xyz_embed=JEmbed(num_freqs=2),
                           dir_embed=JEmbed(num_freqs=1), **common),
            tzoo.ZooConfig(xyz_embed=TEmbed(num_freqs=2),
                           dir_embed=TEmbed(num_freqs=1), **common))


def _models(kind):
    """(JAX model, its variables, the port's model with the same weights).
    The hash field's sigma_out bias starts at 5: its tables start at
    ~2e-4, so without it the density, and every colour and latent
    gradient with it, would be ~0 (tests/test_field_zoo.py does the
    same)."""
    jcfg, tcfg = _cfgs(kind)
    jmodel = jzoo.ZooFieldModel(jcfg)
    v = jax.tree.map(np.array, jmodel.init_variables(jax.random.key(0)))
    if kind == "hash":
        for twr in ("coarse", "fine"):
            v["params"][twr]["sigma_out"]["bias"][0] = 5.0
    tmodel = tzoo.ZooFieldModel(tcfg, device="cpu")
    tmodel.load_state_dict(zoo_from_jax_variables(v))
    return jmodel, jax.tree.map(jnp.asarray, v), tmodel


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-12)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def batch():
    eyes = [(2.0 * np.sin(a), 0.3, 2.0 * np.cos(a)) for a in (0.0, 0.7)]
    poses = np.stack([look_at_pose(np.array(e, np.float32)) for e in eyes])
    return {"rgb": RNG.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "poses": poses,
            "hists": RNG.integers(0, 100, (B, BINS)).astype(np.float32)}


def _take(a, idx):
    return jnp.asarray(np.take_along_axis(
        a.reshape(B, H * W, -1), np.broadcast_to(idx, (B, idx.shape[-1]))
        [..., None], axis=1))


def _jax_update(params, grads, lr):
    tx = jtrainer.make_optimizer()
    opt = tx.init(params)
    opt.hyperparams["learning_rate"] = jnp.asarray(lr)
    updates, _ = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates)


def test_latents_match_jax():
    jmodel, v, tmodel = _models("nerfw")
    hists = np.array([[3.0, 50.4, 99.5, 0.0], [127.6, 3.0, 200.0, -4.0]],
                     np.float32)
    for h in hists:
        ja, jt = jmodel.latents(v["params"], jnp.asarray(h))
        ta, tt = tmodel.latents(t(h))
        close(ta, ja, 0, 0, "a")
        close(tt, jt, 0, 0, "t")
    ta, tt = tmodel.latents(t(hists))
    assert ta.shape == (2, BINS * 5) and tt.shape == (2, BINS * 2)
    # every ray of a batch's one-pass render takes its image's latents:
    # the batch's fine field on rays 3b..3b+2 is image b's fine field
    _, fine = tmodel.ray_field_fns(t(hists), rays_per_image=3)
    x = t(RNG.normal(size=(6, 5, 15)))
    d = t(RNG.normal(size=(6, 5, 9)))
    out = fine(x, d)
    for b in range(2):
        _, fine_b = tmodel.ray_field_fns(t(hists[b]))
        want = fine_b(x[3 * b:3 * b + 3], d[3 * b:3 * b + 3])
        for k in ("static_rgb", "transient_rgb", "transient_beta"):
            close(out[k][3 * b:3 * b + 3], want[k], 1e-6, 1e-6, k)
    assert tzoo.ZooFieldModel(_cfgs("nerf")[1], device="cpu").latents(
        t(hists[0])) == (None, None)


@pytest.fixture(scope="module", params=KINDS)
def step_ref(request, batch):
    """For a kind: the models, the render configs, the pixels and crop
    corners, and the JAX loss, gradients and updated parameters of the
    ray step and the patch step."""
    kind = request.param
    jmodel, v, tmodel = _models(kind)
    jcfg, tcfg = _cfgs(kind)
    kw = dict(n_samples=4, n_importance=4, perturb=False)
    jrc, trc = jcfg.render_config(**kw), tcfg.render_config(**kw)
    idx = np.stack([RNG.choice(H * W, N_PIX, replace=False)
                    for _ in range(B)]).astype(np.int64)
    h0 = RNG.integers(0, H - CROP_SIZE, NUM_CROPS)
    w0 = RNG.integers(0, W - CROP_SIZE, NUM_CROPS)
    dy, dx = np.meshgrid(np.arange(CROP_SIZE), np.arange(CROP_SIZE),
                         indexing="ij")
    idx_p = ((h0[:, None, None] + dy) * W
             + (w0[:, None, None] + dx)).reshape(-1)
    hists = jnp.asarray(batch["hists"])
    poses = jnp.asarray(batch["poses"])

    def loss(params, px, py, target):
        out = jtrainer._render_selected(jmodel, params, poses, px, py, hists,
                                        H, W, FOCAL, NEAR, FAR,
                                        jax.random.key(0), jrc)
        out = jtrainer._finalize_rgb(jmodel, params, out, hists)
        return jlosses.nefes_training_loss(out, target, None,
                                           fusion_out=None, stage=0)[0]

    step = jax.jit(jax.value_and_grad(loss))
    res = {}
    for name, pix in (("rays", idx), ("patch", idx_p)):
        pix = np.broadcast_to(pix, (B, pix.shape[-1]))
        lv, g = step(v["params"], jnp.asarray(pix % W, jnp.float32),
                     jnp.asarray(pix // W, jnp.float32),
                     _take(batch["rgb"], pix))
        res[name] = jax.tree.map(np.asarray, (
            lv, g, _jax_update(v["params"], g, LR)))
    return kind, tmodel, trc, idx, (h0, w0), res


def _check_step(tmodel, loss, want):
    jl, jg, jp = want
    close(loss, jl, 1e-5, 0, "loss")
    state = create_train_state(tmodel)
    apply_gradients(state, loss, LR)
    grads = zoo_from_jax_variables({"params": jg})
    params = zoo_from_jax_variables({"params": jp})
    names = dict(tmodel.named_parameters())
    assert set(names) == set(grads)
    moved_tables = set()
    for name, p in names.items():
        got_g = p.grad if p.grad is not None else torch.zeros_like(p)
        _scaled_close(got_g, grads[name], 1e-4, f"grad {name}")
        # Adam's first step moves a weight by lr·g / (|g| + 1e-8): where
        # |g| is within a few orders of 1e-8 the gradients' rounding moves
        # it by up to lr either way (the hash tables' sparse rows, dead
        # units), so 1e-3 lr is held where |g| > 1e-6 and lr elsewhere
        big = np.abs(grads[name].numpy()) > 1e-6
        d = np.abs(n(p) - params[name].numpy())
        assert d[big].max(initial=0) <= 1e-3 * LR, (name, d[big].max())
        assert d.max(initial=0) <= 2 * LR, (name, d.max())
        if ("embedding" in name or "level_" in name) \
                and np.abs(grads[name].numpy()).max() > 0:
            moved_tables.add(name)
    return moved_tables


def test_rays_step_matches_jax(step_ref, batch):
    kind, tmodel, trc, idx, _, ref = step_ref
    tmodel = copy.deepcopy(tmodel)      # the step updates it in place
    tb = {k: t(v) for k, v in batch.items()}
    loss, metrics = rays_loss(tmodel, trc, tb, torch.from_numpy(idx),
                              torch.Generator().manual_seed(0), (H, W, FOCAL),
                              NEAR, FAR, stage=0)
    assert {"loss_rgb", "psnr"} <= set(metrics)
    tables = _check_step(tmodel, loss, ref["rays"])
    # the appearance table (nerfw, hash) and the hash levels of both
    # towers take gradients
    if kind != "nerf":
        assert "embed_a.embedding" in tables, tables
    if kind == "hash":
        for twr in ("coarse", "fine"):
            assert any(k.startswith(f"{twr}.encoder.") for k in tables)


def test_patch_step_matches_jax(step_ref, batch):
    kind, tmodel, trc, _, (h0, w0), ref = step_ref
    tmodel = copy.deepcopy(tmodel)
    tb = {k: t(v) for k, v in batch.items()}
    loss, metrics, stats = patch_loss(
        tmodel, trc, tb, torch.from_numpy(h0), torch.from_numpy(w0),
        torch.Generator().manual_seed(0), (H, W, FOCAL), NEAR, FAR)
    assert stats is None and "psnr" in metrics
    _check_step(tmodel, loss, ref["patch"])


def test_l1normloss_on_hash_field(batch):
    jmodel, v, tmodel = _models("hash")
    jcfg, tcfg = _cfgs("hash")
    aux = dict(l1normloss=True, l1normloss_w=10.0)
    jrc = jcfg.render_config(n_samples=4, n_importance=4)
    want, jg = jax.value_and_grad(lambda p: jtrainer.aux_regularizers(
        jtrainer.AuxConfig(**aux), jmodel, p, {}, jax.random.key(0),
        jrc))(v["params"])
    got = aux_regularizers(AuxConfig(**aux), tmodel, {"rgb": torch.zeros(1)},
                           tcfg.render_config())
    close(got, want, 1e-5, 0, "l1 term")
    got.backward()
    grads = zoo_from_jax_variables(jax.tree.map(np.asarray, {"params": jg}))
    for name, p in tmodel.named_parameters():
        if "level_" in name:
            _scaled_close(p.grad, grads[name], 1e-4, name)
    # in a step the term raises the objective
    trc = tcfg.render_config(n_samples=4, n_importance=4, perturb=False)
    tb = {k: t(x) for k, x in batch.items()}
    losses = []
    for a in (AuxConfig(), AuxConfig(**aux)):
        _, _, tm = _models("hash")
        _, lv, _ = train_step_rays(create_train_state(tm), trc, tb,
                                   torch.Generator().manual_seed(2), LR,
                                   (H, W, FOCAL), NEAR, FAR, n_rand=8,
                                   aux=a)
        losses.append(float(lv))
    assert losses[1] > losses[0], losses
    with pytest.raises(ValueError, match="hash"):
        tzoo.ZooFieldModel(_cfgs("nerfw")[1], device="cpu").encoder_fns()


def test_zoo_runs_no_kernel():
    tmodel = tzoo.ZooFieldModel(_cfgs("nerfw")[1], device="cpu")
    with pytest.raises(ValueError, match="no kernel"):
        tmodel.field_fns(tmodel.cfg.render_config(fused=True))


def test_validation_render_with_latents():
    jmodel, v, tmodel = _models("nerfw")
    jcfg, tcfg = _cfgs("nerfw")
    kw = dict(n_samples=4, n_importance=4, perturb=False)
    jrc, trc = jcfg.render_config(**kw).test(), tcfg.render_config(**kw).test()
    pose = look_at_pose(np.array([0.0, 0.3, 1.5], np.float32))
    poses = np.stack([pose, pose])
    hists = RNG.integers(0, 100, (2, BINS)).astype(np.float32)
    gt = RNG.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    hwf = (16, 16, 12.0)
    want = jrender_path(jmodel, v, poses, hists, hwf, 0.3, 3.0, jrc,
                        gt_images=gt)
    got = render_path(tmodel, poses, hists, hwf, 0.3, 3.0, trc,
                      gt_images=gt)
    close(got["frames_rgb"], want["frames_rgb"], 1e-5, 1e-5, "rgb")
    close(got["frames_disp"], want["frames_disp"], 1e-5, 1e-5, "disp")
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-5)
    # each view's latents condition its render
    h2 = hists.copy()
    h2[1] = (h2[1] + 37) % 100
    other = render_path(tmodel, poses, h2, hwf, 0.3, 3.0, trc, gt_images=gt)
    assert not np.allclose(other["frames_rgb"][1], got["frames_rgb"][1])
    np.testing.assert_array_equal(other["frames_rgb"][0],
                                  got["frames_rgb"][0])


def test_zoo_checkpoint_round_trip(tmp_path, batch):
    _, _, tmodel = _models("hash")
    trc = _cfgs("hash")[1].render_config(n_samples=4, n_importance=4,
                                         perturb=False)
    state = create_train_state(tmodel)
    tb = {k: t(x) for k, x in batch.items()}
    train_step_rays(state, trc, tb, torch.Generator().manual_seed(1), LR,
                    (H, W, FOCAL), NEAR, FAR, n_rand=8)
    state.epoch = 3
    save_checkpoint(tmp_path / "ckpts", state, 3)
    _, _, fresh = _models("hash")
    back = restore_checkpoint(latest_checkpoint(tmp_path / "ckpts"),
                              create_train_state(fresh))
    assert back.epoch == 3 and back.tx.count == 1
    for (k, a), b in zip(tmodel.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.tx.mu + state.tx.nu, back.tx.mu + back.tx.nu):
        assert torch.equal(a, b)
