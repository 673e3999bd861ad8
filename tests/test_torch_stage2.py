"""The accuracy pipeline's stage 2 (FusionNet's patch steps), stepped in
the port and in the JAX package side by side, on the CPU in f32 at a
tiny model size, to find where the port's stage 2 departs from JAX's
(ROADMAP Queue C2: the port's FusionNet collapsed in stage 2 on the card
where the JAX record's did not).

Both start from the JAX model's weights (carried across by
weights.from_jax_variables) and take STEPS steps of train_step_patch's
body at the same numpy-drawn crop corners on the same batch, with
perturb off (so the render draws nothing), the accuracy command's
gradient clip (global norm 1.0, optax's clip_by_global_norm) and Adam at
the stage's learning rate. After every step the test holds the loss,
the global gradient norm before the clip, and FusionNet's BN running
mean and variance (relative to their largest entry) to the larger of a
base tolerance (loss 2e-5, norm and BN 1e-4: the single step's of
tests/test_torch_train.py) and twice the gap between JAX and JAX
itself started from its weights moved by one f32 rounding (a random
sign each): Adam's first steps divide each gradient by its own
magnitude, and FusionNet's conv3 bias has a zero gradient in exact
arithmetic (the BN after it removes it) that rounding walks by about
the learning rate a step, so the steps amplify any rounding, JAX's own
included, and that gap is the trajectory's resolution. It also checks
that the clip was active (the norm above 1.0) at the first step, as in
the pipeline, so that the clip is what is compared.

Finding (recorded in ROADMAP C2): the port follows JAX within that
resolution at every step; stage 2's update is not where the port's
FusionNet parts from JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nefes_tpu.train import losses as jlosses
from nefes_tpu.train import trainer as jtrainer
from nefes_tpu_torch.data.synthetic import look_at_pose
from nefes_tpu_torch.train.trainer import (
    CROP_SIZE, NUM_CROPS, make_optimizer, patch_loss,
)
from tests.torch_parity import configs, models, n, t

B, H, W, FOCAL, NEAR, FAR = 2, 24, 24, 22.0, 0.5, 4.0
STEPS, LR, CLIP = 8, 5e-4, 1.0


@pytest.fixture(scope="module")
def one_torch_thread():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    eyes = [(2.0 * np.sin(a), 0.3, 2.0 * np.cos(a)) for a in (0.0, 0.6)]
    batch = {"rgb": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "feat": rng.normal(0, 1, (B, H, W, 8)).astype(np.float32),
             "poses": np.stack([look_at_pose(np.array(e, np.float32))
                                for e in eyes]),
             "hists": rng.uniform(0, 30, (B, 10)).round().astype(
                 np.float32)}
    corners = [(rng.integers(0, H - CROP_SIZE, NUM_CROPS),
                rng.integers(0, W - CROP_SIZE, NUM_CROPS))
               for _ in range(STEPS)]
    kw = dict(n_samples=8, n_importance=8, perturb=False,
              output_transient=True)
    return (jmodel, variables, tmodel, jcfg.render_config(**kw),
            tcfg.render_config(**kw), batch, corners)


def _jax_steps(jmodel, starts, jrc, batch, corners):
    """JAX's train_step_patch at given corners, STEPS times from each of
    starts (variables): per step the loss, the global gradient norm and
    the new running statistics."""
    tx = jtrainer.make_optimizer(grad_clip=CLIP)
    hists = jnp.asarray(batch["hists"])
    poses = jnp.asarray(batch["poses"])

    def take(a, idx):
        return jnp.asarray(a).reshape(B, H * W, -1)[:, idx]

    @jax.jit
    def step(v, opt, h0, w0):
        dy, dx = jnp.meshgrid(jnp.arange(CROP_SIZE), jnp.arange(CROP_SIZE),
                              indexing="ij")
        py = (h0[:, None, None] + dy).reshape(-1)
        px = (w0[:, None, None] + dx).reshape(-1)
        idx = py * W + px

        def loss_fn(v):
            full = lambda a: jnp.broadcast_to(  # noqa: E731
                a.astype(jnp.float32), (B, idx.size))
            out = jtrainer._render_selected(
                jmodel, v["params"], poses, full(px), full(py), hists, H, W,
                FOCAL, NEAR, FAR, jax.random.key(0), jrc)
            out = jtrainer._finalize_rgb(jmodel, v["params"], out, hists)
            as_img = lambda x: x.reshape(  # noqa: E731
                B * NUM_CROPS, CROP_SIZE, CROP_SIZE, x.shape[-1])
            fo, new_bs = jmodel.apply_fusion(v, as_img(out["rgb"]),
                                             as_img(out["feat"]), train=True)
            loss, _ = jlosses.nefes_training_loss(
                out, take(batch["rgb"], idx), take(batch["feat"], idx),
                fusion_out=fo.reshape(B, idx.size, -1), stage=2)
            return loss, new_bs

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(v)
        g = g["params"]
        opt.hyperparams["learning_rate"] = jnp.asarray(LR)
        updates, opt = tx.update(g, opt, v["params"])
        v = {"params": optax.apply_updates(v["params"], updates),
             "batch_stats": {"fusion": new_bs}}
        return v, opt, loss, optax.global_norm(g)

    runs = []
    for v in starts:
        out, opt = [], tx.init(v["params"])
        for h0, w0 in corners:
            v, opt, loss, norm = step(v, opt, jnp.asarray(h0),
                                      jnp.asarray(w0))
            bn = v["batch_stats"]["fusion"]["bn"]
            out.append((float(loss), float(norm), np.asarray(bn["mean"]),
                        np.asarray(bn["var"])))
        runs.append(out)
    return runs


def _gaps(a, b):
    """Relative gaps of two steps' (loss, norm, BN mean, BN var)."""
    return [abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]),
            *(float(np.abs(x - y).max() / np.abs(y).max())
              for x, y in zip(a[2:], b[2:]))]


def test_stage2_steps_match_jax(setup, one_torch_thread):
    jmodel, variables, tmodel, jrc, trc, batch, corners = setup
    rs = np.random.default_rng(0)
    nudged = jax.tree.map(lambda x: (x * (1 + 2.0 ** -24 * rs.choice(
        [-1, 1], size=np.shape(x)))).astype(np.float32), variables)
    want, again = _jax_steps(jmodel, [variables, nudged], jrc, batch,
                             corners)
    tb = {k: t(v) for k, v in batch.items()}
    tx = make_optimizer(tmodel.parameters(), grad_clip=CLIP)
    bn = tmodel.fusion.bn
    base = (2e-5, 1e-4, 1e-4, 1e-4)
    for i, (h0, w0) in enumerate(corners):
        # train_step_patch's body at the step's corners
        loss, _, new_stats = patch_loss(
            tmodel, trc, tb, torch.as_tensor(h0), torch.as_tensor(w0), None,
            (H, W, FOCAL), NEAR, FAR)
        tx.zero_grad()
        loss.backward()
        norm = float(torch.sqrt(sum(torch.sum(p.grad ** 2)
                                    for p in tx.params
                                    if p.grad is not None)))
        tx.step(LR)
        bn.running_mean.copy_(new_stats["running_mean"])
        bn.running_var.copy_(new_stats["running_var"])
        if i == 0:
            assert norm > CLIP, norm           # the clip acts, as on the card
        got = (float(loss.detach()), norm, n(bn.running_mean),
               n(bn.running_var))
        gaps, floor = _gaps(got, want[i]), _gaps(again[i], want[i])
        for name, g, b, f in zip(("loss", "norm", "BN mean", "BN var"),
                                 gaps, base, floor):
            assert g <= max(b, 2 * f), (i, name, g, b, f)
