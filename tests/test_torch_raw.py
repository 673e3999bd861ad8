"""The port's raw-input kernel path (K5-K8) against the JAX package, on the
CPU in f32, where the wrappers run the kernels' plain versions.

1. The plain versions of K5/K6 (modes sigma and full) and K7/K8 against
   make_fused_field / make_fused_render in interpret mode: values, and the
   gradients w.r.t. the points, the directions and z. The embedding runs
   at the full 10/4 bands, so the top band's phases reach hundreds of
   radians. Same arithmetic in another summation order: values to 2e-5,
   gradients to 1e-4 of their scale (the chain rule through the top band
   multiplies each embedding cotangent by up to 2^9).
2. render_rays through the port's raw fns against the JAX package's raw
   render_rays (the kernels in interpret mode, as
   tests/test_renderer_fused.py runs them), with the fine pass through
   the field kernels (K5/K6) and through the composite-fused render
   (K7/K8): values to 2e-4 / 2e-5 and the gradients w.r.t. the ray
   origins and directions, the refinement's gradient path, to 1e-4 of
   their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.kernels.fused_field import FieldSpec as JSpec
from nefes_tpu.kernels.fused_field import fused_field_apply as jfield
from nefes_tpu.kernels.fused_field import pack_params as jpack
from nefes_tpu.kernels.fused_render import fused_render_apply as jrender
from nefes_tpu.render.renderer import render_rays as jrender_rays
from nefes_tpu_torch.kernels import fused_field as kf
from nefes_tpu_torch.kernels import fused_render as kr
from nefes_tpu_torch.render.renderer import render_rays
from tests.torch_parity import close, configs, models, n, replace, t

RNG = np.random.default_rng(2)


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-3)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def field():
    jcfg, tcfg = configs(depth=4, width=32, feature_dim=8, skips=(2,),
                         xyz_freqs=10, dir_freqs=4)
    _, variables, tmodel = models(jcfg, tcfg)
    jspec = JSpec.from_model(jcfg, "fine", dtype="float32", tile=64)
    jw = jpack(variables["params"]["fine"], jspec)
    _, packed_f = tmodel.pack_fused()
    return jspec, jw, tmodel.fused_spec("fine"), packed_f


def _rays(R, S):
    pts = RNG.normal(0, 0.7, (R, S, 3)).astype(np.float32)
    dirs = RNG.normal(0, 1, (R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


@pytest.mark.parametrize("sigma_only", [True, False],
                         ids=["sigma", "full"])
def test_field_plain_matches_pallas(field, sigma_only):
    """K5 forward (f32 heads) and K6's d_pts / d_dirs (need_dw=False)."""
    jspec, jw, spec, packed = field
    pts, vd = _rays(5, 13)                      # 65 samples: a ragged tile
    dirs = np.broadcast_to(vd[:, None], pts.shape).copy()
    gw = {"static_sigma": 0.3, "static_rgb": 1.7, "static_feat": 0.01}

    def jloss(a, b):
        out = jfield(jspec, jw, a, None if sigma_only else b,
                     sigma_only=sigma_only, output_transient=False,
                     need_dw=False, interpret=True)
        return sum(jnp.sum(v ** 2) * gw[k] for k, v in out.items()), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(jnp.asarray(pts),
                                                     jnp.asarray(dirs))
    pt, dt = t(pts, True), t(dirs, True)
    got = kf.fused_field_apply(spec, packed, pt, None if sigma_only else dt,
                               sigma_only=sigma_only, output_transient=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == np.float32
        close(got[k], want[k], 2e-5, 2e-5, k)
    sum((v ** 2).sum() * gw[k] for k, v in got.items()).backward()
    _scaled_close(pt.grad, jg[0], 1e-4, "d_pts")
    if not sigma_only:
        _scaled_close(dt.grad, jg[1], 1e-4, "d_dirs")


def test_render_plain_matches_pallas(field):
    """K7 forward and K8's d_pts, d_dirs (summed over each ray's samples
    by autograd of the broadcast) and d_z, with the feature channels kept
    out of the weights' cotangent."""
    jspec, jw, spec, packed = field
    R, S = 8, 32
    pts, vd = _rays(R, S)
    z = np.sort(RNG.uniform(0.3, 4.0, (R, S)), -1).astype(np.float32)

    def score(o):
        return ((o["rgb"] ** 2).sum() + 0.1 * (o["feat"] ** 2).sum()
                + 0.05 * o["depth"].sum() + 0.02 * o["acc"].sum())

    def jloss(a, b, c):
        o = jrender(jspec, jw, a, b, c, interpret=True)
        return score(o), o

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(z))
    pt, dt, zt = t(pts, True), t(vd, True), t(z, True)
    got = kr.fused_render_apply(spec, packed, pt, dt, zt)
    for k in ("rgb", "feat", "depth", "acc", "disp"):
        close(got[k], want[k], 2e-5, 2e-5, k)
    score(got).backward()
    for g, w, name in zip((pt.grad, dt.grad, zt.grad), jg,
                          ("d_pts", "d_viewdirs", "d_z")):
        _scaled_close(g, w, 1e-4, name)


def test_raw_wrappers_refuse_other_devices(field):
    _, _, _, packed = field
    x = t(np.zeros((4, 3))).to("meta")
    with pytest.raises(ValueError):
        kf.field_fwd(packed, False, x, None)
    with pytest.raises(ValueError):
        kr.render_fwd(packed, x, x, t(np.zeros((1, 4))).to("meta"))


# --- the renderer through the raw fns ---

@pytest.fixture(scope="module")
def render_setup():
    jcfg, tcfg = configs()
    jmodel, variables, tmodel = models(jcfg, tcfg)
    rays_o = (RNG.normal(0, 1, (12, 3)) * 0.1).astype(np.float32)
    rays_d = RNG.normal(0, 1, (12, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    kw = dict(n_samples=8, n_importance=8, perturb=False, test_time=True,
              output_transient=False)
    return (jmodel, variables, jcfg.render_config(**kw), tmodel,
            tcfg.render_config(**kw), rays_o, rays_d)


@pytest.mark.parametrize("fused_render", [False, True],
                         ids=["fused_raw", "render_raw"])
def test_render_rays_raw_matches_jax(render_setup, fused_render):
    jmodel, variables, jrc, tmodel, trc, rays_o, rays_d = render_setup
    flags = dict(fused=True, fused_pre=False, fused_need_dw=False,
                 fused_render=fused_render)
    pc, pf = jmodel.pack_fused(variables["params"])
    fine_j = (jmodel.fine_render_raw_fn(interpret=True) if fused_render
              else jmodel.fine_raw_fn(need_dw=False, interpret=True))

    def jrun(o, d):
        out = jrender_rays(jmodel.coarse_raw_fn(need_dw=False,
                                                interpret=True),
                           fine_j, pc, pf, o, d, 0.1, 4.0, None,
                           replace(jrc, **flags))
        return jnp.sum(out["feat"] ** 2) + jnp.sum(out["rgb"]), out

    (_, want), jg = jax.value_and_grad(jrun, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rays_o), jnp.asarray(rays_d))
    tpc, tpf = tmodel.pack_fused()
    fine_t = (tmodel.fine_render_raw_fn(tpf) if fused_render
              else tmodel.fine_raw_fn(tpf))
    ot, dt = t(rays_o, True), t(rays_d, True)
    got = render_rays(tmodel.coarse_raw_fn(tpc), fine_t, ot, dt, 0.1, 4.0,
                      None, replace(trc, **flags))
    for k in ("rgb", "feat", "disp", "acc", "depth"):
        close(got[k], want[k], 2e-4, 2e-5, k)
    ((got["feat"] ** 2).sum() + got["rgb"].sum()).backward()
    _scaled_close(ot.grad, jg[0], 1e-4, "d rays_o")
    _scaled_close(dt.grad, jg[1], 1e-4, "d rays_d")
