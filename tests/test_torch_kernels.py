"""The port's fused-field (K1, K2) and composite-fused render (K3, K4)
kernels, and the host builds of their raw-input counterparts (K5-K8;
their plain versions are held to the JAX package in test_torch_raw.py).

1. Their plain PyTorch versions (what a wrapper runs for a CPU tensor)
   against the JAX package's Pallas kernels in interpret mode, values and
   gradients w.r.t. the embeddings and z, f32. Same arithmetic in another
   summation order: values to 2e-5, gradients to 1e-4 of their scale.
2. The CUDA sources themselves, compiled for the host with the C++
   compiler under NEFES_EMULATE (one thread per block), against the plain
   versions in f32, to 1e-5 of scale: the kernels' indexing and tiling,
   with a ragged last tile and with whole tiles, and for K5-K8 the
   in-kernel embedding and its chain rule (sinf/cosf of the C library
   against torch's), checked without a card.
   The host build refuses bf16: bf16 runs on the tensor cores, which only
   the card has, so bf16 is checked by 3.
3. On a card (marked cuda; skipped on a machine without one): each kernel
   against its plain version on the card, by relative L2 error (see the
   test).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.fields.embedder import embed as jembed
from nefes_tpu.kernels.fused_field import FieldSpec as JSpec
from nefes_tpu.kernels.fused_field import fused_field_apply_pre as jfield
from nefes_tpu.kernels.fused_field import pack_params as jpack
from nefes_tpu.kernels.fused_render import fused_render_apply_pre as jrender
from nefes_tpu_torch.fields.nerfh_nff import NeRFHNFF
from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels import fused_field as kf
from nefes_tpu_torch.kernels import fused_render as kr
from tests.torch_parity import close, configs, models, n, t

RNG = np.random.default_rng(1)


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-3)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def field():
    jcfg, tcfg = configs(depth=4, width=32, feature_dim=8, skips=(2,),
                         xyz_freqs=6, dir_freqs=3)
    jmodel, variables, tmodel = models(jcfg, tcfg)
    jspec = JSpec.from_model(jcfg, "fine", dtype="float32", tile=64)
    jw = jpack(variables["params"]["fine"], jspec, pre_embedded=True)
    _, packed_f = tmodel.pack_fused()
    return jcfg, jspec, jw, tmodel.fused_spec("fine"), packed_f


def _embeds(jcfg, R, S):
    pts = RNG.normal(0, 0.7, (R, S, 3)).astype(np.float32)
    dirs = RNG.normal(0, 1, (R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xe = np.asarray(jembed(jnp.asarray(pts), jcfg.xyz_embed))
    de = np.asarray(jembed(jnp.broadcast_to(jnp.asarray(dirs)[:, None],
                                            pts.shape), jcfg.dir_embed))
    return xe, de


@pytest.mark.parametrize("sigma_only", [True, False])
def test_field_plain_matches_pallas(field, sigma_only):
    """K1 forward and K2 (need_dw=False) embedding cotangents."""
    jcfg, jspec, jw, spec, packed = field
    xe, de = _embeds(jcfg, 5, 13)                # 65 rows: a ragged tile
    gw = {"static_sigma": 0.3, "static_rgb": 1.7, "static_feat": 0.01}

    def jloss(a, b):
        out = jfield(jspec, jw, a, b, sigma_only=sigma_only,
                     output_transient=False, need_dw=False, interpret=True)
        return sum(jnp.sum(v ** 2) * gw[k] for k, v in out.items()), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(jnp.asarray(xe),
                                                     jnp.asarray(de))
    xt, dt = t(xe, True), t(de, True)
    got = kf.fused_field_apply_pre(spec, packed, xt, dt,
                                   sigma_only=sigma_only,
                                   output_transient=False)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 2e-5, 2e-5, k)
    sum((v ** 2).sum() * gw[k] for k, v in got.items()).backward()
    _scaled_close(xt.grad, jg[0], 1e-4, "d_emb")
    if not sigma_only:
        _scaled_close(dt.grad, jg[1], 1e-4, "d_embd")


def test_render_plain_matches_pallas(field):
    """K3 forward and K4's d_emb, d_embd and d_z, with the feature
    channels kept out of the weights' cotangent."""
    jcfg, jspec, jw, spec, packed = field
    R, S = 8, 32
    xe, de = _embeds(jcfg, R, S)
    z = np.sort(RNG.uniform(0.3, 4.0, (R, S)), -1).astype(np.float32)

    def score(o):
        return ((o["rgb"] ** 2).sum() + 0.1 * (o["feat"] ** 2).sum()
                + 0.05 * o["depth"].sum() + 0.02 * o["acc"].sum())

    def jloss(a, b, c):
        o = jrender(jspec, jw, a, b, c, interpret=True)
        return score(o), o

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(xe), jnp.asarray(de), jnp.asarray(z))
    xt, dt, zt = t(xe, True), t(de, True), t(z, True)
    got = kr.fused_render_apply_pre(spec, packed, xt, dt, zt)
    for k in ("rgb", "feat", "depth", "acc", "disp"):
        close(got[k], want[k], 2e-5, 2e-5, k)
    score(got).backward()
    for g, w, name in zip((xt.grad, dt.grad, zt.grad), jg,
                          ("d_emb", "d_embd", "d_z")):
        _scaled_close(g, w, 1e-4, name)


def test_unported_options_raise(field):
    _, _, _, spec, packed = field
    xe = torch.zeros(4, spec.emb_xyz)
    de = torch.zeros(4, spec.emb_dir)
    with pytest.raises(NotImplementedError):
        kf.fused_field_apply_pre(spec, packed, xe, de, need_dw=True)
    with pytest.raises(NotImplementedError):
        kf.fused_field_apply_pre(spec, packed, xe, de,
                                 output_transient=True)


# --- the CUDA sources, built for the host ---

@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Directory of the host (emulated) builds of the CUDA sources."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    path = tmp_path_factory.mktemp("host_build")
    build.build_all(emulate=True, build_dir=path)
    return path


def _emulated_case():
    gen = torch.Generator().manual_seed(0)
    spec = kf.FieldSpec(depth=4, width=64, skips=(2,), n_freqs_xyz=4,
                        n_freqs_dir=2, feature_dim=8, transient=True,
                        dtype="float32")
    tower = NeRFHNFF(typ="fine", depth=4, width=64, skips=(2,),
                     in_channels_xyz=spec.emb_xyz,
                     in_channels_dir=spec.emb_dir, feature_dim=8)
    with torch.no_grad():
        for prm in tower.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
    packed = kf.pack_params(tower, spec)
    return spec, packed, gen


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(dtype)


def _inputs(gen, spec, N, raw):
    """(x, dirs, their plain-version dtype, the heads' dtype, the input
    cotangents' widths): pre-embedded rows in the pack dtype, or raw
    points and directions in f32 (points at the scale of a scene, so the
    top band's phases reach tens of radians)."""
    cd = spec.torch_dtype
    if raw:
        return (torch.randn((N, 3), generator=gen) * 1.5,
                torch.nn.functional.normalize(
                    torch.randn((N, 3), generator=gen), dim=-1),
                torch.float32, (3, 3))
    return (_rand(gen, (N, spec.emb_xyz), cd),
            _rand(gen, (N, spec.emb_dir), cd), cd,
            (spec.emb_xyz, spec.emb_dir))


_KIND = {False: "pre", True: "raw"}


# N rows: 100 ends in a ragged tile of 36, 128 is two whole tiles of 64
@pytest.mark.parametrize("N,raw", [
    pytest.param(100, False, id="float32"),
    pytest.param(128, False, id="float32-whole-tiles"),
    pytest.param(100, True, id="raw-float32"),
    pytest.param(128, True, id="raw-float32-whole-tiles")])
def test_field_source_matches_plain(N, raw, host_build):
    """K1/K2, or with raw K5/K6, against their plain versions."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    fwd = getattr(lib, f"nefes_field_fwd_{_KIND[raw]}")
    bwd = getattr(lib, f"nefes_field_bwd_{_KIND[raw]}")
    plain_fwd = kf.field_fwd_plain if raw else kf.field_fwd_pre_plain
    plain_bwd = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    cd, F, tol = spec.torch_dtype, spec.feature_dim, 1e-5
    # bf16 (code 1) is refused before any pointer is read
    assert fwd(1, 0, N, None, None, None, None, *kf.dims(spec), None, None,
               None, None) != 0
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, N, raw)
    for full in (False, True):
        outs = [torch.empty(N, dtype=hd), torch.empty((N, 3), dtype=hd),
                torch.empty((N, F), dtype=hd)]
        err = fwd(kf._DTYPE_CODE[cd], int(full), N, x.data_ptr(),
                  dirs.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
                  *kf.dims(spec), *[o.data_ptr() for o in outs], None)
        assert err == 0
        want = plain_fwd(p, full, x, dirs)
        for o, w in zip(outs, want):
            if w is not None:
                assert w.dtype == hd
                _scaled_close(o, w, tol)
        g = [_rand(gen, (N,), hd), _rand(gen, (N, 3), hd),
             _rand(gen, (N, F), hd)]
        d = [torch.empty((N, dx_w), dtype=hd),
             torch.empty((N, dd_w), dtype=hd)]
        err = bwd(kf._DTYPE_CODE[cd], int(full), N, x.data_ptr(),
                  dirs.data_ptr(), p.w.data_ptr(), p.wt.data_ptr(),
                  p.b.data_ptr(), *kf.dims(spec), *[v.data_ptr() for v in g],
                  *[v.data_ptr() for v in d], None)
        assert err == 0
        want = plain_bwd(p, full, x, dirs, *g)
        for o, w in zip(d, want):
            if w is not None:
                _scaled_close(o, w, tol)


# S samples per ray: 70 is a whole tile and a ragged one (64 + 6), 128
# the main path's two whole tiles
@pytest.mark.parametrize("S,raw", [
    pytest.param(70, False, id="float32"),
    pytest.param(128, False, id="float32-whole-tiles"),
    pytest.param(70, True, id="raw-float32"),
    pytest.param(128, True, id="raw-float32-whole-tiles")])
def test_render_source_matches_plain(S, raw, host_build):
    """K3/K4, or with raw K7/K8, against their plain versions."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_render", emulate=True, build_dir=host_build)
    fwd = getattr(lib, f"nefes_render_fwd_{_KIND[raw]}")
    bwd = getattr(lib, f"nefes_render_bwd_{_KIND[raw]}")
    plain_fwd = kr.render_fwd_plain if raw else kr.render_fwd_pre_plain
    plain_bwd = kr.render_bwd_plain if raw else kr.render_bwd_pre_plain
    cd, R, C, tol = spec.torch_dtype, 4, spec.rgbfeat, 1e-5
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, R * S, raw)
    z = torch.sort(torch.rand((R, S), generator=gen) * 4, 1).values
    out = torch.empty((R, C + 2))
    err = fwd(kf._DTYPE_CODE[cd], R, S, x.data_ptr(), dirs.data_ptr(),
              z.data_ptr(), p.w.data_ptr(), p.b.data_ptr(), *kf.dims(spec),
              out.data_ptr(), None)
    assert err == 0
    _scaled_close(out, plain_fwd(p, x, dirs, z), tol)
    g = torch.randn((R, C + 2), generator=gen)
    d = [torch.empty((R * S, dx_w), dtype=hd),
         torch.empty((R * S, dd_w), dtype=hd), torch.empty((R, S))]
    err = bwd(kf._DTYPE_CODE[cd], R, S, x.data_ptr(), dirs.data_ptr(),
              z.data_ptr(), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
              *kf.dims(spec), g.data_ptr(), *[v.data_ptr() for v in d], None)
    assert err == 0
    for o, w in zip(d, plain_bwd(p, x, dirs, z, g)):
        _scaled_close(o, w, tol)


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda, dtype):
    """Each of K1-K8 against its plain version on the same card inputs,
    by relative L2 error: bf16 1e-2, f32 1e-5. In bf16 the tensor cores
    and cuBLAS sum in another order, so a hidden unit within one rounding
    of 0 can fall on the other side of the ReLU, and a backward then
    passes or drops that unit's cotangent: single entries may differ by
    ~10 % while the tensor agrees."""
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    cfg = ModelConfig(depth=4, width=128, feature_dim=16, skips=(2,),
                      dtype=kf._DTYPES[dtype])
    model = NeFeSModel(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    pc, pf = model.pack_fused()
    spec = pf.spec
    cd, tol = spec.torch_dtype, (1e-5 if dtype == "float32" else 1e-2)

    def agree(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm()) <= tol
    R, S = 64, 128
    emb = torch.randn((R * S, spec.emb_xyz), device=cuda).to(cd)
    embd = torch.randn((R * S, spec.emb_dir), device=cuda).to(cd)
    z = torch.sort(torch.rand((R, S), device=cuda) * 4, 1).values
    for full in (False, True):
        got = kf.field_fwd_pre(pf, full, emb, embd)
        want = kf.field_fwd_pre_plain(pf, full, emb, embd)
        for a, b in zip(got, want):
            if b is not None:
                agree(a, b)
    g = [torch.randn(s, device=cuda).to(cd)
         for s in ((R * S,), (R * S, 3), (R * S, spec.feature_dim))]
    for a, b in zip(kf.field_bwd_pre(pf, True, emb, embd, *g),
                    kf.field_bwd_pre_plain(pf, True, emb, embd, *g)):
        agree(a, b)
    agree(kr.render_fwd_pre(pf, emb, embd, z),
          kr.render_fwd_pre_plain(pf, emb, embd, z))
    gr = torch.randn((R, spec.rgbfeat + 2), device=cuda)
    for a, b in zip(kr.render_bwd_pre(pf, emb, embd, z, gr),
                    kr.render_bwd_pre_plain(pf, emb, embd, z, gr)):
        agree(a, b)
    # K5-K8 on raw points (at the scale of a scene) and directions
    pts = torch.randn((R * S, 3), device=cuda) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn((R * S, 3),
                                                     device=cuda), dim=-1)
    for full in (False, True):
        for a, b in zip(kf.field_fwd(pf, full, pts, dirs),
                        kf.field_fwd_plain(pf, full, pts, dirs)):
            if b is not None:
                agree(a, b)
    g = [torch.randn(s, device=cuda)
         for s in ((R * S,), (R * S, 3), (R * S, spec.feature_dim))]
    for a, b in zip(kf.field_bwd(pf, True, pts, dirs, *g),
                    kf.field_bwd_plain(pf, True, pts, dirs, *g)):
        agree(a, b)
    agree(kr.render_fwd(pf, pts, dirs, z), kr.render_fwd_plain(pf, pts, dirs, z))
    for a, b in zip(kr.render_bwd(pf, pts, dirs, z, gr),
                    kr.render_bwd_plain(pf, pts, dirs, z, gr)):
        agree(a, b)
    torch.cuda.synchronize()
