"""The port's auxiliary losses and Nerfies window against the JAX
package's, on the CPU in f32 at a tiny model size (the kernel wrappers
run their plain versions).

1. Every function of train/aux_losses.py on the same numpy inputs
   (seeded), values and input gradients to 1e-6 relative; the TV loss on
   the cube corners that JAX drew from its key, at the training step's
   64³ grid and the reference's default 512×256×512.
2. cosine_window / train_windows to 1e-7; the windowed embed, values and
   the gradients of x and the window, to 1e-6.
3. One step against the JAX package's train_step_rays / train_step_patch
   bodies at given pixels and crop corners, held to test_torch_train.py's
   _compare_step bounds (loss 1e-5 relative, every gradient to 2e-4 of
   its scale, the parameters after one Adam step): a stage-1 random-ray
   step with every aux term on (TV at tvloss_w 1, so that its gradient
   shows, Cauchy and mean sigma sparsity, the DPT depth term), on the
   plain fields and through K5/K6 +dW (their plain versions); a stage-1
   random-ray step and a stage-2 patch step under a half-open window
   (alpha = 0.4·F), on the plain fields and through K1/K2 +dW. The JAX
   side runs its plain fields: the kernels' plain versions equal them to
   summation order.
4. A window on the raw-input kernels raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.fields import embedder as jemb
from nefes_tpu.train import aux_losses as jaux
from nefes_tpu.train import losses as jlosses
from nefes_tpu.train import trainer as jtrainer
from nefes_tpu_torch.fields import embedder as temb
from nefes_tpu_torch.render.renderer import render_rays
from nefes_tpu_torch.train import aux_losses as taux
from nefes_tpu_torch.train import create_train_state, patch_loss, rays_loss
from nefes_tpu_torch.train.model import NeFeSModel
from nefes_tpu_torch.train.trainer import AuxConfig, apply_gradients
from tests.test_torch_train import _compare_step, _fresh_tmodel
from tests.torch_parity import close, configs, models, n, replace, t

RNG = np.random.default_rng(11)
H, W, FOCAL, NEAR, FAR = 20, 24, 18.0, 0.5, 4.0
B, N_PIX, LR = 2, 12, 1e-3
AUX = dict(tvloss=True, tvloss_w=1.0, sigma_sparsity=True,
           sigma_sparsity2=True, depth=True, bound=FAR)
# a half-open window: alpha = 0.4·F of each embedding
WIN_EPOCH, WIN_FULL = 4.0, 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _rel(got, want, tol, msg=""):
    np.testing.assert_allclose(n(got), n(want), rtol=tol,
                               atol=tol * max(float(np.abs(n(want)).max()),
                                              1e-30), err_msg=msg)


def _density(lib):
    """The same smooth density in both frameworks: x (N, 3) -> (N,)."""
    def sigma(x):
        return 5.0 * (lib.sin(7.0 * x[:, 0]) + lib.cos(5.0 * x[:, 1])
                      * x[:, 2]) ** 2
    return sigma


def _jax_corners(key, res):
    keys = jax.random.split(key, 3)
    return [int(jax.random.randint(keys[i], (), 0, res[i] - res[i] // 10))
            for i in range(3)]


@pytest.mark.parametrize("res", [(64, 64, 64), (512, 256, 512)])
def test_total_variation_on_jax_corners(res):
    key = jax.random.key(5)
    want = jax.jit(lambda k: jaux.total_variation_loss(
        k, _density(jnp), _density(jnp), sample_resolution=res))(key)
    corners = _jax_corners(key, res)
    got = taux.total_variation_loss(_density(torch), _density(torch),
                                    corners, sample_resolution=res)
    _rel(got, want, 1e-6)
    # drawn from a generator: corners in range, the same loss as given
    gen = torch.Generator().manual_seed(0)
    drawn = taux.tv_corners(gen, res)
    assert all(0 <= int(c) < s - s // 10 for c, s in zip(drawn, res))
    again = taux.total_variation_loss(
        _density(torch), _density(torch), None,
        torch.Generator().manual_seed(0), sample_resolution=res)
    assert float(again) == float(taux.total_variation_loss(
        _density(torch), _density(torch), drawn, sample_resolution=res))


def test_embeddings_l1_matches_jax():
    A = RNG.normal(0, 1, (3, 8)).astype(np.float32)
    want = jax.jit(lambda: jaux.embeddings_l1_loss(
        lambda x: jnp.sin(x @ A), lambda x: jnp.cos(x @ A) ** 3))()
    got = taux.embeddings_l1_loss(lambda x: torch.sin(x @ t(A)),
                                  lambda x: torch.cos(x @ t(A)) ** 3)
    _rel(got, want, 1e-6)


def _value_and_grad_both(jfn, tfn, *arrays):
    """jfn / tfn on the same arrays: values and the gradients of a
    scalar weighted sum of the output with respect to every input."""
    wts = [None]

    def jscalar(*xs):
        out = jfn(*xs)
        if wts[0] is None:
            wts[0] = RNG.uniform(0.5, 1.5, np.shape(out)).astype(np.float32)
        return jnp.sum(out * wts[0]), out

    (_, jv), jg = jax.jit(jax.value_and_grad(jscalar, argnums=tuple(
        range(len(arrays))), has_aux=True))(*[jnp.asarray(a) for a in arrays])
    ts = [t(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    torch.sum(tv * t(wts[0])).backward()
    return (tv, jv), [(x.grad, g) for x, g in zip(ts, jg)]


@pytest.mark.parametrize("name", [
    "sigma_sparsity_loss", "sigma_sparsity_loss2", "compute_depth_loss odd",
    "compute_depth_loss even", "depth_loss_dpt", "depth_loss_dpt weighted",
    "compute_smooth_loss"])
def test_aux_function_matches_jax(name):
    """Values and input gradients to 1e-6 relative; the depth losses on
    odd and even element counts (the median of an even count is the mean
    of the two middle values, as jnp.median's)."""
    fn = name.split()[0]
    jfn, tfn = getattr(jaux, fn), getattr(taux, fn)
    if fn.startswith("sigma"):
        arrays = [RNG.uniform(0, 3, (5, 11)).astype(np.float32)]
    elif fn == "compute_depth_loss":
        m = 37 if name.endswith("odd") else 36
        arrays = [RNG.uniform(0.1, 5.0, (2, m)).astype(np.float32)
                  for _ in range(2)]
    elif fn == "depth_loss_dpt":
        arrays = [RNG.uniform(0.1, 5.0, (9, 8)).astype(np.float32)
                  for _ in range(3 if name.endswith("weighted") else 2)]
    else:
        arrays = [RNG.uniform(0.5, 2.0, (2, 8, 10, 1)).astype(np.float32),
                  RNG.uniform(size=(2, 8, 10, 3)).astype(np.float32)]
    (tv, jv), grads = _value_and_grad_both(jfn, tfn, *arrays)
    _rel(tv, jv, 1e-6, f"{name} value")
    for i, (g_t, g_j) in enumerate(grads):
        _rel(g_t, g_j, 1e-6, f"{name} grad {i}")


def test_cosine_window_matches_jax():
    for F in (1, 4, 10):
        for epoch, full in ((0.0, 5.0), (1.0, 7.0), (4.0, 10.0),
                            (13.0, 9.0), (250.0, 600.0)):
            close(temb.cosine_window(F, epoch, full),
                  jemb.cosine_window(F, epoch, full), 0, 1e-7, f"{F} {epoch}")
    xyz, dirs = temb.EmbedConfig(num_freqs=10), temb.EmbedConfig(num_freqs=4)
    got = temb.train_windows(3.0, xyz, dirs, 8.0)
    want = jemb.train_windows(3.0, jemb.EmbedConfig(num_freqs=10),
                              jemb.EmbedConfig(num_freqs=4), 8.0)
    for g, w in zip(got, want):
        close(g, w, 0, 1e-7)


def test_windowed_embed_matches_jax():
    x = RNG.normal(0, 1.5, (7, 5, 3)).astype(np.float32)
    win = np.asarray(jemb.cosine_window(6, WIN_EPOCH, WIN_FULL))
    jcfg, tcfg = jemb.EmbedConfig(num_freqs=6), temb.EmbedConfig(num_freqs=6)
    (tv, jv), grads = _value_and_grad_both(
        lambda a, w: jemb.embed(a, jcfg, window=w),
        lambda a, w: temb.embed(a, tcfg, w), x, win)
    _rel(tv, jv, 1e-6, "value")
    for i, (g_t, g_j) in enumerate(grads):
        _rel(g_t, g_j, 1e-6, f"grad {i}")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    from nefes_tpu_torch.data.synthetic import look_at_pose
    eyes = [(2.0 * np.sin(a), 0.3, 2.0 * np.cos(a)) for a in (0.2, 0.9)]
    poses = np.stack([look_at_pose(np.array(e, np.float32)) for e in eyes])
    batch = {"rgb": RNG.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "feat": RNG.normal(0, 1, (B, H, W, 8)).astype(np.float32),
             "depth": RNG.uniform(0.5, 4.0, (B, H, W)).astype(np.float32),
             "poses": poses,
             "hists": RNG.uniform(0, 30, (B, 10)).round().astype(np.float32)}
    kw = dict(n_samples=8, n_importance=8, perturb=False,
              output_transient=True)
    return jcfg, tcfg, jcfg.render_config(**kw), tcfg.render_config(**kw), \
        batch


@pytest.fixture(scope="module")
def ref(setup):
    """The JAX side of every step test in one jitted program: the
    stage-1 random-ray step with the aux terms at the pixels idx, the
    stage-1 random-ray step under the window, and the patch step under
    the window at the corners (h0, w0): loss, gradients, parameters after
    one Adam step."""
    jcfg, tcfg, jrc, _, batch = setup
    jmodel, variables, _ = models(jcfg, tcfg, seed=2)
    idx = np.stack([RNG.choice(H * W, N_PIX, replace=False)
                    for _ in range(B)]).astype(np.int64)
    C = jtrainer.CROP_SIZE
    h0 = RNG.integers(0, H - C, jtrainer.NUM_CROPS)
    w0 = RNG.integers(0, W - C, jtrainer.NUM_CROPS)
    hists, poses = jnp.asarray(batch["hists"]), jnp.asarray(batch["poses"])
    aux_key = jax.random.key(9)
    window = jemb.train_windows(WIN_EPOCH, jcfg.xyz_embed, jcfg.dir_embed,
                                WIN_FULL)

    def take(a, i):
        return jnp.asarray(np.take_along_axis(
            a.reshape(B, H * W, -1), np.broadcast_to(i, (B, i.shape[-1]))
            [..., None], axis=1))

    def render(params, px, py, win):
        return jtrainer._finalize_rgb(jmodel, params, jtrainer._render_selected(
            jmodel, params, poses, px, py, hists, H, W, FOCAL, NEAR, FAR,
            jax.random.key(0), jrc, win), hists)

    px = jnp.asarray((idx % W).astype(np.float32))
    py = jnp.asarray((idx // W).astype(np.float32))

    def rays(params, aux_on):
        out = render(params, px, py, None if aux_on else window)
        loss = jlosses.nefes_training_loss(
            out, take(batch["rgb"], idx), take(batch["feat"], idx),
            fusion_out=None, stage=1)[0]
        if aux_on:
            aux = jtrainer.AuxConfig(**AUX)
            loss = loss + jtrainer.aux_regularizers(
                aux, jmodel, params, out, aux_key, jrc)
            loss = loss + aux.depth_w * jaux.compute_depth_loss(
                out["depth"], take(batch["depth"][..., None], idx)[..., 0])
        return loss

    dy, dx = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
    py_p = (h0[:, None, None] + dy).reshape(-1)
    px_p = (w0[:, None, None] + dx).reshape(-1)
    idx_p = py_p * W + px_p

    def patch(v):
        params = v["params"]
        full = lambda a: jnp.broadcast_to(  # noqa: E731
            jnp.asarray(a, jnp.float32), (B, idx_p.size))
        out = render(params, full(px_p), full(py_p), window)
        as_img = lambda x: x.reshape(B * jtrainer.NUM_CROPS, C, C,  # noqa
                                     x.shape[-1])
        fo, _ = jmodel.apply_fusion(v, as_img(out["rgb"]),
                                    as_img(out["feat"]), train=True)
        return jlosses.nefes_training_loss(
            out, take(batch["rgb"], idx_p), take(batch["feat"], idx_p),
            fo.reshape(B, idx_p.size, -1), 2)[0]

    def run(v):
        params, res = v["params"], {}
        for name, aux_on in (("aux", True), ("window", False)):
            loss, g = jax.value_and_grad(rays)(params, aux_on)
            res[name] = (loss, g, jtrainer_update(params, g))
        loss, g = jax.value_and_grad(patch)(v)
        res["patch"] = (loss, g["params"],
                        jtrainer_update(params, g["params"]))
        return res

    res = jax.jit(run)(variables)
    return (variables, idx, (h0, w0), _jax_corners(aux_key, (64, 64, 64)),
            jax.tree.map(np.asarray, res))


def jtrainer_update(params, grads):
    import optax
    tx = jtrainer.make_optimizer()
    opt = tx.init(params)
    opt.hyperparams["learning_rate"] = jnp.asarray(LR)
    updates, _ = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates)


def _windows(tcfg):
    return temb.train_windows(WIN_EPOCH, tcfg.xyz_embed, tcfg.dir_embed,
                              WIN_FULL)


ROUTES = {"unfused": {},
          "raw": dict(fused=True, fused_pre=False, fused_need_dw=True),
          "pre": dict(fused=True, fused_pre=True, fused_need_dw=True)}


@pytest.mark.parametrize("case,route", [
    ("aux", "unfused"), ("aux", "raw"), ("window", "unfused"),
    ("window", "pre"), ("patch", "unfused"), ("patch", "pre")])
def test_step_matches_jax(setup, ref, case, route):
    _, tcfg, _, trc, batch = setup
    variables, idx, (h0, w0), corners, res = ref
    jl, jg, jnew = res[case]
    tmodel = _fresh_tmodel(tcfg, variables)
    cfg = replace(trc, **ROUTES[route])
    st = create_train_state(tmodel)
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    tb = {k: t(v) for k, v in batch.items()}
    if case == "patch":
        loss, _, _ = patch_loss(tmodel, cfg, tb, torch.from_numpy(h0),
                                torch.from_numpy(w0), None, (H, W, FOCAL),
                                NEAR, FAR, window=_windows(tcfg))
    elif case == "aux":
        loss, metrics = rays_loss(tmodel, cfg, tb, torch.from_numpy(idx),
                                  None, (H, W, FOCAL), NEAR, FAR, stage=1,
                                  aux=AuxConfig(**AUX), tv_corners=corners)
        assert "loss_depth" in metrics
    else:
        loss, _ = rays_loss(tmodel, cfg, tb, torch.from_numpy(idx), None,
                            (H, W, FOCAL), NEAR, FAR, stage=1,
                            window=_windows(tcfg))
    close(loss, jl, 1e-5, 1e-6, "loss")
    apply_gradients(st, loss, LR)
    _compare_step(tmodel, before, variables, jg, jnew, tcfg,
                  f"{case} {route}")


def test_raw_kernels_refuse_the_window(setup):
    _, tcfg, _, trc, _ = setup
    tmodel = NeFeSModel(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    cfg = replace(trc, **ROUTES["raw"])
    ro = t(RNG.normal(0, 0.1, (4, 3)))
    rd = t(RNG.normal(0, 1, (4, 3)))
    with pytest.raises(ValueError, match="window"):
        render_rays(*tmodel.field_fns(cfg), ro, rd, NEAR, FAR, None, cfg,
                    window=_windows(tcfg))
