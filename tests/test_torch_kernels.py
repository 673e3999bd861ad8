"""The port's fused-field (K1, K2) and composite-fused render (K3, K4)
kernels, and the host builds of their raw-input counterparts (K5-K8;
their plain versions are held to the JAX package in test_torch_raw.py).

1. Their plain PyTorch versions (what a wrapper runs for a CPU tensor)
   against the JAX package's Pallas kernels in interpret mode, values and
   gradients w.r.t. the embeddings and z, f32. Same arithmetic in another
   summation order: values to 2e-5, gradients to 1e-4 of their scale. The
   training variants (K1/K5 transient mode, K2/K6 with need_dw) through
   autograd of the packed blobs, against jax.grad through pack_params
   (as tests/test_fused_field.py does): heads to 2e-5, the gradients of
   every parameter of the tower and of the inputs to 2e-4 of their
   scale, that test's tolerance.
2. The CUDA sources themselves, compiled for the host with the C++
   compiler under NEFES_EMULATE (one thread per block), against the plain
   versions in f32, to 1e-5 of scale: the kernels' indexing and tiling,
   with a ragged last tile and with whole tiles (K1/K5's warp path in
   sigma, full and transient mode also at 1 sample, on a persistent grid
   of 2 blocks over 5 block tiles, in sigma mode without dirs, and at the
   full-width tower, with its shared memory a block), and for K5-K8 the
   in-kernel embedding and its chain rule (sinf/cosf of the C library
   against torch's), the transient heads, and the weight gradients of
   K2/K6 (the backward over chunks of rows, the dW kernel on each chunk's
   row slices, one and several, and their reduction; the dW kernel alone
   against field_dw_plain; two calls bit for bit; the chunk plan at the
   training shapes), checked without a card. K2/K6's warp path (sigma
   and full mode) also at the full-width tower, over chunks that end mid
   block tile, and on a persistent grid of 2 blocks and one block per
   block tile, bit for bit the same, with its shared memory a block. The render kernels at
   the full-width tower and up to 1,024 samples a ray (the backward's
   per-sample state past a block's 232,448 bytes of shared memory, in its
   global scratch), and the build of another tree's sources
   (chip_smoke.py --parent).
   The host build refuses bf16: bf16 runs on the tensor cores, which only
   the card has, so bf16 is checked by 3.
3. On a card (marked cuda; skipped on a machine without one): each kernel
   against its plain version on the card, by relative L2 error (see the
   test).
"""

import shutil
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.fields.embedder import embed as jembed
from nefes_tpu.kernels.fused_field import FieldSpec as JSpec
from nefes_tpu.kernels.fused_field import fused_field_apply as jfield_raw
from nefes_tpu.kernels.fused_field import fused_field_apply_pre as jfield
from nefes_tpu.kernels.fused_field import pack_params as jpack
from nefes_tpu.kernels.fused_render import fused_render_apply_pre as jrender
from nefes_tpu_torch.fields.nerfh_nff import NeRFHNFF
from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels import fused_field as kf
from nefes_tpu_torch.kernels import fused_render as kr
from tests.torch_parity import close, configs, grads_by_name, models, n, t

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
    with torch.no_grad():
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
    """Every mode and need_dw are ported; what is left to refuse: weight
    gradients of a field packed without autograd (a frozen pack would
    drop them silently), and transient mode on a tower without the
    transient heads."""
    _, _, _, spec, packed = field
    xe = torch.zeros(4, spec.emb_xyz)
    de = torch.zeros(4, spec.emb_dir)
    with pytest.raises(ValueError, match="need_dw"):
        kf.fused_field_apply_pre(spec, packed, xe, de, need_dw=True)
    out = kf.fused_field_apply_pre(spec, packed, xe, de,
                                   output_transient=True)
    assert "transient_beta" in out
    coarse = kf.PackedField(spec=replace(packed.spec, transient=False),
                            weights=packed.weights, w=packed.w,
                            wt=packed.wt, b=packed.b)
    with pytest.raises(ValueError, match="transient"):
        kf.field_fwd_pre(coarse, kf.TRANSIENT, xe, de)


_GW = {"static_sigma": 0.3, "static_rgb": 1.7, "static_feat": 0.01,
       "transient_sigma": 0.5, "transient_rgb": 0.8, "transient_beta": 0.4}


@pytest.fixture(scope="module")
def train_field():
    """A fine tower (transient heads) in both packages, its JAX params and
    the port's model, whose parameters take gradients."""
    jcfg, tcfg = configs(depth=4, width=32, feature_dim=8, skips=(2,),
                         xyz_freqs=6, dir_freqs=3)
    _, variables, tmodel = models(jcfg, tcfg)
    jspec = JSpec.from_model(jcfg, "fine", dtype="float32", tile=64)
    return jcfg, tcfg, jspec, variables, tmodel


@pytest.mark.parametrize("raw", [False, True], ids=["pre", "raw"])
@pytest.mark.parametrize("sigma_only,transient", [
    pytest.param(True, False, id="sigma"),
    pytest.param(False, False, id="full"),
    pytest.param(False, True, id="transient")])
def test_field_training_variants_match_pallas(train_field, raw, sigma_only,
                                              transient):
    """K1/K2 (pre) or K5/K6 (raw) with need_dw=True, in each mode: the
    heads, and the gradients of the tower's parameters and of the inputs,
    through the packed blobs and autograd, against jax.grad through
    pack_params and the Pallas kernels (interpret mode)."""
    jcfg, tcfg, jspec, variables, tmodel = train_field
    pts = RNG.normal(0, 0.7, (5, 13, 3)).astype(np.float32)  # ragged tile
    vd = RNG.normal(0, 1, (5, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    dirs = np.broadcast_to(vd[:, None], pts.shape).copy()
    if raw:
        xin = pts
        din = dirs
    else:
        xin, din = _embeds_of(jcfg, pts, dirs)

    def jloss(params, a, b):
        w = jpack(params, jspec, pre_embedded=not raw)
        apply = jfield_raw if raw else jfield
        out = apply(jspec, w, a, None if (raw and sigma_only) else b,
                    sigma_only=sigma_only, output_transient=transient,
                    need_dw=True, interpret=True)
        return sum(jnp.sum(v ** 2) * _GW[k] for k, v in out.items()), out

    (_, want), (jg_p, jg_x, jg_d) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"]["fine"], jnp.asarray(xin), jnp.asarray(din))
    tmodel.zero_grad(set_to_none=True)
    spec = tmodel.fused_spec("fine")
    packed = kf.pack_params(tmodel.fine, spec)
    xt, dt = t(xin, True), t(din, True)
    apply = kf.fused_field_apply if raw else kf.fused_field_apply_pre
    got = apply(spec, packed, xt, None if (raw and sigma_only) else dt,
                sigma_only=sigma_only, output_transient=transient,
                need_dw=True)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 2e-5, 2e-5, k)
    sum((v ** 2).sum() * _GW[k] for k, v in got.items()).backward()
    want_g = grads_by_name({"fine": jg_p}, variables, tcfg)
    for name, prm in tmodel.fine.named_parameters():
        key = f"fine.{name}"
        if prm.grad is None:
            # only the unused heads of this mode may go without
            assert not np.abs(want_g[key]).any(), key
            continue
        _scaled_close(prm.grad, want_g[key], 2e-4, key)
    _scaled_close(xt.grad, jg_x, 2e-4, "d_x")
    if not sigma_only:
        _scaled_close(dt.grad, jg_d, 2e-4, "d_dirs")


def _embeds_of(jcfg, pts, dirs):
    xe = np.asarray(jembed(jnp.asarray(pts), jcfg.xyz_embed))
    de = np.asarray(jembed(jnp.asarray(dirs), jcfg.dir_embed))
    return xe, de


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


def _host_bwd(lib, raw, p, mode, x, dirs, g, d, chunk=0, slices=0,
              blocks=None):
    """Call the host-built K2/K6; with chunk > 0 with dW, over chunks of
    `chunk` rows, each followed by the host-built dW kernel on `slices`
    row slices, returning the reduced f32 weight gradients. blocks: the
    persistent grid of the warp path (sigma and full mode) through the
    _grid entry point (0: one block per block tile); None: the entry
    point's own grid (the host build's: one block)."""
    spec, cd = p.spec, p.spec.torch_dtype
    grid = () if blocks is None else (blocks,)
    bwd = getattr(lib, f"nefes_field_bwd_{_KIND[raw]}"
                  + ("_grid" if grid else ""))
    N, nw, nb = x.shape[0], p.w.numel(), p.b.numel()

    def launch(row0, rows, ops, tile_b):
        assert bwd(kf._DTYPE_CODE[cd], mode, N, x.data_ptr(),
                   kf._ptr(dirs), p.w.data_ptr(), p.wt.data_ptr(),
                   p.b.data_ptr(), *kf.dims(spec), *[v.data_ptr() for v in g],
                   *[v.data_ptr() for v in d], row0, rows, nb, kf._ptr(ops),
                   kf._ptr(tile_b), *grid, None) == 0

    if not chunk:
        launch(0, N, None, None)
        return None

    def dw(ops, tile_b, rows, part):
        assert kf.dw_launch(lib, p, mode, ops, tile_b, rows, part, None) == 0

    part = kf.bwd_dw(lib, launch, dw, p, mode, N, chunk, slices, "cpu")
    out = torch.empty(nw + nb)
    assert lib.nefes_field_dw_reduce(slices, nw + nb, part.data_ptr(),
                                     out.data_ptr(), None) == 0
    return out


def _cotangents(gen, N, F, hd):
    return [_rand(gen, (N,), hd), _rand(gen, (N, 3), hd),
            _rand(gen, (N, F), hd), _rand(gen, (N, 5), hd)]


def _host_fwd(lib, raw, p, mode, x, dirs, blocks=0):
    """K1 (or raw K5) of the host build: (sigma, rgb, feat, transient),
    all four allocated whatever the mode. blocks: the persistent grid of
    the warp path (0: one block per block tile)."""
    spec, N = p.spec, x.shape[0]
    hd = torch.float32 if raw else spec.torch_dtype
    outs = [torch.empty(N, dtype=hd), torch.empty((N, 3), dtype=hd),
            torch.empty((N, spec.feature_dim), dtype=hd),
            torch.empty((N, 5), dtype=hd)]
    err = getattr(lib, f"nefes_field_fwd_{_KIND[raw]}")(
        kf._DTYPE_CODE[spec.torch_dtype], mode, N, x.data_ptr(),
        kf._ptr(dirs), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
        *kf.dims(spec), *[o.data_ptr() for o in outs], blocks, None)
    assert err == 0
    return outs


# N rows: 100 is one ragged block tile of 128 for the forward (six whole
# warps, one of 4 rows, one empty) and, for the backward, a tile of 64 and
# a ragged one of 36; 256 is two whole block tiles, four whole tiles of 64
@pytest.mark.parametrize("N,raw", [
    pytest.param(100, False, id="float32"),
    pytest.param(256, False, id="float32-whole-tiles"),
    pytest.param(100, True, id="raw-float32"),
    pytest.param(256, True, id="raw-float32-whole-tiles")])
def test_field_source_matches_plain(N, raw, host_build):
    """K1/K2, or with raw K5/K6, against their plain versions, in the
    sigma, full and transient modes (the backward without dW)."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    fwd = getattr(lib, f"nefes_field_fwd_{_KIND[raw]}")
    plain_fwd = kf.field_fwd_plain if raw else kf.field_fwd_pre_plain
    plain_bwd = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    F, tol = spec.feature_dim, 1e-5
    # bf16 (code 1) is refused before any pointer is read
    assert fwd(1, 0, N, None, None, None, None, None, *kf.dims(spec), None,
               None, None, None, 0, None) != 0
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, N, raw)
    for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
        outs = _host_fwd(lib, raw, p, mode, x, dirs)
        want = plain_fwd(p, mode, x, dirs)
        assert sum(w is not None for w in want) == (1, 3, 4)[mode]
        for o, w in zip(outs, want):
            if w is not None:
                assert w.dtype == hd
                _scaled_close(o, w, tol)
        g = _cotangents(gen, N, F, hd)
        d = [torch.empty((N, dx_w), dtype=hd),
             torch.empty((N, dd_w), dtype=hd)]
        assert _host_bwd(lib, raw, p, mode, x, dirs, g, d) is None
        want = plain_bwd(p, mode, x, dirs, *g)
        assert want[2] is None
        for o, w in zip(d, want[:2]):
            if w is not None:
                _scaled_close(o, w, tol)


# chunk: the rows of one launch of the backward with dW (a multiple of the
# 64-row tile), slices: the dW kernel's row slices of a chunk (whole
# tiles each). One chunk on one slice with a ragged tile; 3 slices over 2
# tiles (an idle slice); two tiles a slice, the last one ragged; whole
# tiles on 2 slices; 300 rows in chunks of 128 (the last of 44 rows, mid
# tile) on 2 slices, and in chunks of 192 on 3 slices (the last chunk of
# 108 rows leaves a slice idle)
@pytest.mark.parametrize("N,raw,chunk,slices", [
    pytest.param(100, False, 128, 1, id="float32-one-slice"),
    pytest.param(128, False, 128, 3, id="float32-idle-slice"),
    pytest.param(150, True, 192, 2, id="raw-float32-two-tiles-a-slice"),
    pytest.param(128, True, 128, 2, id="raw-float32-whole-tiles"),
    pytest.param(300, False, 128, 2, id="float32-chunks"),
    pytest.param(300, True, 192, 3, id="raw-float32-chunks")])
def test_field_source_dw_matches_plain(N, raw, chunk, slices, host_build):
    """K2/K6 with need_dw, in each mode: the input cotangents and every
    packed weight's f32 gradient (the backward over chunks, the dW kernel
    on each chunk's row slices, then their sum) against the plain
    versions."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    plain_bwd = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    F, tol = spec.feature_dim, 1e-5
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, N, raw)
    nw = p.w.numel()
    for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
        g = _cotangents(gen, N, F, hd)
        d = [torch.empty((N, dx_w), dtype=hd),
             torch.empty((N, dd_w), dtype=hd)]
        dw = _host_bwd(lib, raw, p, mode, x, dirs, g, d, chunk, slices)
        want = plain_bwd(p, mode, x, dirs, *g, need_dw=True)
        for o, w in zip(d, want[:2]):
            if w is not None:
                _scaled_close(o, w, tol)
        assert dw.shape == want[2].shape == (nw + p.b.numel(),)
        _scaled_close(dw[:nw], want[2][:nw], tol, f"dW mode {mode}")
        _scaled_close(dw[nw:], want[2][nw:], tol, f"db mode {mode}")


def test_field_source_dw_deterministic(host_build):
    """Two calls of K2 with need_dw on the same inputs give the same bits:
    the weight gradients (summed in a fixed order: tiles, row slices,
    chunks) and the input cotangents."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    N = 300
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, N, False)
    g = _cotangents(gen, N, spec.feature_dim, hd)
    runs = []
    for _ in range(2):
        d = [torch.empty((N, dx_w), dtype=hd),
             torch.empty((N, dd_w), dtype=hd)]
        runs.append([_host_bwd(lib, False, p, kf.TRANSIENT, x, dirs, g, d,
                               128, 3), *d])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def dw_case():
    """A tower whose dW products take every ragged K and N of the
    full-width field: K 27 (dir embedding), 63 (embedding), 64 (half
    width), 128 (width); N 1 (sigma, transient sigma and beta), 3
    (transient rgb), 11 (rgb/feature), 64 and 128."""
    spec = kf.FieldSpec(depth=3, width=128, skips=(2,), n_freqs_xyz=10,
                        n_freqs_dir=4, feature_dim=8, transient=True,
                        dtype="float32")
    tower = NeRFHNFF(typ="fine", depth=3, width=128, skips=(2,),
                     in_channels_xyz=spec.emb_xyz,
                     in_channels_dir=spec.emb_dir, feature_dim=8)
    with torch.no_grad():
        return kf.pack_params(tower, spec)


# rows: 150, two whole tiles and a ragged one; slices: one, and 2 over
# the three tiles (two and one)
@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("mode", [kf.SIGMA, kf.FULL, kf.TRANSIENT],
                         ids=["sigma", "full", "transient"])
def test_field_dw_source_matches_plain(mode, slices, dw_case, host_build):
    """The dW kernel alone (host build, f32) on random operand buffers and
    per-tile bias sums against field_dw_plain, to the scaled 1e-5; the
    products' K and N cover 1, 3, 27, 63, 64 and 128, and the kernel adds
    into what part already holds."""
    p = dw_case
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    rows, nw, nb = 150, p.w.numel(), p.b.numel()
    gen = torch.Generator().manual_seed(mode * 2 + slices)
    elems = lib.nefes_field_dw_row_elems(mode, *kf.dims(p.spec))
    assert elems == sum(-(-c // 8) * 8 for c in kf._slot_cols(p.spec, mode))
    ops = torch.randn(3 * kf.TILE_ROWS * elems, generator=gen)   # 3 tiles
    tile_b = torch.randn((3, nb), generator=gen)
    part = torch.randn((slices, nw + nb), generator=gen)
    before = part.sum(0)
    assert kf.dw_launch(lib, p, mode, ops, tile_b, rows, part, None) == 0
    want = kf.field_dw_plain(p, mode, ops, tile_b, rows)
    used = {n for _, _, n in kf.dw_products(p.spec, mode)}
    assert {n for n in kf.matrix_names(p.spec) if n in used} == used
    _scaled_close(part.sum(0) - before, want, 1e-5, f"mode {mode}")
    # the CPU wrapper runs the plain version into part[0]
    got = kf.field_dw(p, mode, ops, tile_b, rows,
                      torch.zeros((slices, nw + nb)))
    assert torch.equal(got[0], want) and not got[1:].any()


def test_dw_plan_at_training_shape(full_width, host_build):
    """The chunks and row slices of the training step's backward with dW
    at the full-width ModelConfig() in bf16 on an H100's 132 SMs, as
    PERF.md states them (chunks, rows a chunk, bytes of operands a row,
    row slices): the fine pass's 786,432 rows in transient mode, the
    coarse pass's 393,216 in full mode, within DW_SCRATCH_BYTES."""
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    for p, mode, n, want in ((full_width[1], kf.TRANSIENT, 786432, DW_FINE),
                             (full_width[0], kf.FULL, 393216, DW_COARSE)):
        p = kf.PackedField(spec=replace(p.spec, dtype="bfloat16"),
                           weights=p.weights, w=p.w, wt=p.wt, b=p.b)
        chunk, slices = kf.dw_plan(lib, p, mode, n, 132)
        row = lib.nefes_field_dw_row_elems(mode, *kf.dims(p.spec)) * 2
        assert chunk % kf.TILE_ROWS == 0
        assert (chunk * row + chunk // kf.TILE_ROWS * p.b.numel() * 4
                <= kf.DW_SCRATCH_BYTES)
        assert (-(-n // chunk), chunk, row, slices) == want


def _field_fwd_case(lib, raw, p, mode, N, blocks, gen):
    """K1/K5 of the host build against the plain version at N samples, in
    sigma mode with dirs null (the warp path stops after the sigma head
    and reads no directions), to the scaled 1e-5: every head of the mode,
    the transient ones included."""
    x, dirs, _, _ = _inputs(gen, p.spec, N, raw)
    if mode == kf.SIGMA:
        dirs = None
    plain = kf.field_fwd_plain if raw else kf.field_fwd_pre_plain
    want = plain(p, mode, x, dirs)
    assert sum(w is not None for w in want) == (1, 3, 4)[mode]
    for o, w, name in zip(_host_fwd(lib, raw, p, mode, x, dirs, blocks),
                          want, ("sigma", "rgb", "feat", "transient")):
        if w is not None:
            _scaled_close(o, w, 1e-5, f"{name} N={N} blocks={blocks}")


# The warp path of K1/K5 (sigma, full and transient mode): N = 1, one
# sample in one warp; N = 300, three block tiles of 128 the last ragged
# (44 rows: two whole warps, one of 12); N = 600 over blocks = 2, five
# block tiles (the last of 88 rows) on a persistent grid of two blocks,
# so each block walks two or three tiles and its weight stages carry on
# across them (in transient mode the longer sequence, through the
# transient branch's five matrices)
@pytest.mark.parametrize("mode", [kf.SIGMA, kf.FULL, kf.TRANSIENT],
                         ids=["sigma", "full", "transient"])
@pytest.mark.parametrize("raw", [False, True], ids=["pre", "raw"])
@pytest.mark.parametrize("N,blocks", [
    pytest.param(1, 0, id="one-sample"),
    pytest.param(300, 0, id="ragged-block-tile"),
    pytest.param(600, 2, id="two-blocks-five-tiles")])
def test_field_warp_source_matches_plain(N, blocks, raw, mode, host_build):
    """K1 (pre) or K5 (raw) in sigma, full and transient mode, host
    build, against the plain version (the emulated tower is a fine one,
    with transient heads)."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    _field_fwd_case(lib, raw, p, mode, N, blocks, gen)


def _render_fwd_host(lib, raw, p, x, dirs, z):
    """K3 (or raw K7) of the host build: (R, C + 2)."""
    R, S = z.shape
    out = torch.empty((R, p.spec.rgbfeat + 2))
    err = getattr(lib, f"nefes_render_fwd_{_KIND[raw]}")(
        kf._DTYPE_CODE[p.spec.torch_dtype], R, S, x.data_ptr(),
        dirs.data_ptr(), z.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
        *kf.dims(p.spec), out.data_ptr(), None)
    assert err == 0
    return out


def _render_bwd_host(lib, raw, p, x, dirs, z, g, scratch=True):
    """K4 (or raw K8) of the host build, with the global scratch the
    wrapper allocates (none with scratch=False): its outputs, or its
    error code where it refuses."""
    R, S = z.shape
    spec = p.spec
    hd, (dx_w, dd_w) = ((torch.float32, (3, 3)) if raw else
                        (spec.torch_dtype, (spec.emb_xyz, spec.emb_dir)))
    d = [torch.empty((R * S, dx_w), dtype=hd),
         torch.empty((R * S, dd_w), dtype=hd), torch.empty((R, S))]
    buf = kr.bwd_scratch(lib, p, R, S, "cpu") if scratch else None
    err = getattr(lib, f"nefes_render_bwd_{_KIND[raw]}")(
        kf._DTYPE_CODE[spec.torch_dtype], R, S, x.data_ptr(), dirs.data_ptr(),
        z.data_ptr(), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
        *kf.dims(spec), g.data_ptr(), *[v.data_ptr() for v in d],
        kf._ptr(buf), None)
    return d if err == 0 else err


# S samples per ray: 70 is part of one block tile (128 samples, 16 a
# warp), 128 the main path's, 192 one and a half block tiles, 320 two and
# a half (the forward's transmittance carried from tile to tile; the
# backward's per-sample state spans them), 1 a single sample (the
# composite's warp scans hold one element)
@pytest.mark.parametrize("S,raw", [
    pytest.param(70, False, id="float32"),
    pytest.param(128, False, id="float32-whole-tiles"),
    pytest.param(192, False, id="float32-three-tiles"),
    pytest.param(320, False, id="float32-block-tiles"),
    pytest.param(1, False, id="float32-one-sample"),
    pytest.param(70, True, id="raw-float32"),
    pytest.param(128, True, id="raw-float32-whole-tiles"),
    pytest.param(192, True, id="raw-float32-three-tiles"),
    pytest.param(320, True, id="raw-float32-block-tiles"),
    pytest.param(1, True, id="raw-float32-one-sample")])
def test_render_source_matches_plain(S, raw, host_build):
    """K3/K4, or with raw K7/K8, against their plain versions. The
    composite sums its transmittance (and the backward its suffix terms)
    as warp scans over chunks of 32 samples, the forward's K3/K7 the
    rgb/feature head once on the ray's weighted sum of the dir layer, the
    plain version sample by sample: the orders differ by f32 rounding,
    within the scaled 1e-5."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_render", emulate=True, build_dir=host_build)
    plain_fwd = kr.render_fwd_plain if raw else kr.render_fwd_pre_plain
    plain_bwd = kr.render_bwd_plain if raw else kr.render_bwd_pre_plain
    R, C, tol = 4, spec.rgbfeat, 1e-5
    x, dirs, _, _ = _inputs(gen, spec, R * S, raw)
    z = torch.sort(torch.rand((R, S), generator=gen) * 4, 1).values
    _scaled_close(_render_fwd_host(lib, raw, p, x, dirs, z),
                  plain_fwd(p, x, dirs, z), tol)
    g = torch.randn((R, C + 2), generator=gen)
    for o, w in zip(_render_bwd_host(lib, raw, p, x, dirs, z, g),
                    plain_bwd(p, x, dirs, z, g)):
        _scaled_close(o, w, tol)


# the shared memory of one K4/K8 block at the main path's shape (D8/W128,
# 128 samples, bf16) as PERF.md states it
K4_SMEM_BYTES = 208032
BLOCK_SMEM_MAX = 232448
# the shared memory of one K1/K5 block in sigma mode at D8/W128, bf16
K1_SMEM_BYTES = 158208
# the backward with dW at the training shapes (D8/W128/F128, bf16, 132
# SMs): chunks, rows a chunk, operand bytes a row, row slices; the fine
# pass (transient mode) and the coarse pass (full mode)
DW_FINE = (5, 157312, 6160, 7)
DW_COARSE = (2, 196608, 5344, 9)


def test_render_bwd_smem_fits_one_block(host_build):
    """The backward's shared memory at the full-width ModelConfig() and
    128 samples per ray: one block fits an H100 SM, in bf16 (the main
    path) and in f32, and the bf16 figure is PERF.md's."""
    from nefes_tpu_torch.train.model import ModelConfig
    lib = build.library("fused_render", emulate=True, build_dir=host_build)
    spec = kf.FieldSpec.from_model(ModelConfig(), "fine")
    bf16 = lib.nefes_render_smem_bytes(1, 1, 128, *kf.dims(spec))
    f32 = lib.nefes_render_smem_bytes(0, 1, 128, *kf.dims(spec))
    assert bf16 == K4_SMEM_BYTES <= BLOCK_SMEM_MAX
    assert bf16 < f32 <= BLOCK_SMEM_MAX
    # the per-ray state grows with S; the forward keeps its own carve-up
    assert lib.nefes_render_smem_bytes(1, 1, 192, *kf.dims(spec)) > bf16
    assert lib.nefes_render_smem_bytes(1, 0, 128, *kf.dims(spec)) != bf16


@pytest.fixture(scope="module")
def full_width():
    """The coarse and the fine tower of the full-width ModelConfig()
    (D8/W128/F128) in f32, packed."""
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    model = NeFeSModel(ModelConfig(dtype=torch.float32), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model.pack_fused()


# At the full-width tower in f32 a K4/K8 block keeps the per-sample state
# of up to 204 samples in shared memory: 256 and 1,024 put it in the
# global scratch. K3/K7 keep one block tile whatever S is.
@pytest.mark.parametrize("S", [256, 1024])
@pytest.mark.parametrize("kernel", ["K3", "K4", "K7", "K8"])
def test_render_full_width_matches_plain(kernel, S, full_width, host_build):
    """One ray of S samples at the full-width tower in f32: the wrappers'
    checks take it, the block's shared memory stays within 232,448 bytes,
    and the kernel (host build) equals its plain version to the scaled
    1e-5. The backward refuses to launch without the scratch it needs."""
    p, raw = full_width[1], kernel in ("K7", "K8")
    lib = build.library("fused_render", emulate=True, build_dir=host_build)
    gen = torch.Generator().manual_seed(S)
    x, dirs, _, _ = _inputs(gen, p.spec, S, raw)
    z = torch.sort(torch.rand((1, S), generator=gen) * 4, 1).values
    kr._check_render(p, x, dirs, z, raw)
    backward = kernel in ("K4", "K8")
    assert lib.nefes_render_smem_bytes(0, int(backward), S,
                                       *kf.dims(p.spec)) <= BLOCK_SMEM_MAX
    if not backward:
        plain = kr.render_fwd_plain if raw else kr.render_fwd_pre_plain
        _scaled_close(_render_fwd_host(lib, raw, p, x, dirs, z),
                      plain(p, x, dirs, z), 1e-5)
        return
    g = torch.randn((1, p.spec.rgbfeat + 2), generator=gen)
    assert lib.nefes_render_bwd_scratch_bytes(0, S, *kf.dims(p.spec)) > 0
    assert _render_bwd_host(lib, raw, p, x, dirs, z, g, scratch=False) != 0
    plain = kr.render_bwd_plain if raw else kr.render_bwd_pre_plain
    for o, w in zip(_render_bwd_host(lib, raw, p, x, dirs, z, g),
                    plain(p, x, dirs, z, g)):
        _scaled_close(o, w, 1e-5)


@pytest.mark.parametrize("mode", [kf.SIGMA, kf.FULL, kf.TRANSIENT],
                         ids=["sigma", "full", "transient"])
@pytest.mark.parametrize("raw", [False, True], ids=["pre", "raw"])
def test_field_warp_full_width_matches_plain(raw, mode, full_width,
                                             host_build):
    """K1/K5 at the full width (D8/W128/F128) in f32, 200 samples (a block
    tile and a ragged one of 72), host build against the plain version:
    sigma and full mode on the main path's coarse tower, transient mode on
    the fine tower (training's fine pass)."""
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    _field_fwd_case(lib, raw, full_width[int(mode == kf.TRANSIENT)], mode,
                    200, 0, torch.Generator().manual_seed(200))


def test_field_warp_smem_fits_a_block(host_build):
    """The shared memory of one block of K1/K5's warp path at the
    full-width ModelConfig(), in sigma, full and transient mode (the fine
    tower), bf16 and f32: within an H100 block's 232,448 bytes, full mode
    above sigma mode (the dir rows and the larger weight stages),
    transient mode at least full mode, and sigma mode in bf16 at the
    figure PERF.md states."""
    from nefes_tpu_torch.train.model import ModelConfig
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    dims = {mode: kf.dims(kf.FieldSpec.from_model(
        ModelConfig(), "fine" if mode == kf.TRANSIENT else "coarse"))
        for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT)}
    smem = {(code, mode): lib.nefes_field_smem_bytes(code, mode, *dims[mode])
            for code in (0, 1) for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT)}
    assert all(0 < b <= BLOCK_SMEM_MAX for b in smem.values())
    for code in (0, 1):
        assert smem[code, kf.SIGMA] < smem[code, kf.FULL]
        assert smem[code, kf.FULL] <= smem[code, kf.TRANSIENT]
    assert smem[1, kf.SIGMA] == K1_SMEM_BYTES


# The backward K2/K6 in sigma and full mode on the warp path, full width:
# 200 rows, a block tile of 128 and a ragged one of 72 (four whole warps,
# one of 8 rows, three empty), frozen and with dW in one chunk
@pytest.mark.parametrize("need_dw", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("mode", [kf.SIGMA, kf.FULL], ids=["sigma", "full"])
@pytest.mark.parametrize("raw", [False, True], ids=["pre", "raw"])
def test_field_bwd_warp_full_width_matches_plain(raw, mode, need_dw,
                                                 full_width, host_build):
    """K2 (pre) or K6 (raw) at the full width (D8/W128/F128, the main
    path's coarse tower) in f32, 200 rows, host build against the plain
    version to the scaled 1e-5: the input cotangents and, with dW, every
    weight and bias gradient of the mode. In sigma mode dirs is null: the
    warp path reads no directions there."""
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    p, N = full_width[0], 200
    gen = torch.Generator().manual_seed(201 + 2 * mode + need_dw)
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, p.spec, N, raw)
    g = _cotangents(gen, N, p.spec.feature_dim, hd)
    d = [torch.empty((N, dx_w), dtype=hd), torch.empty((N, dd_w), dtype=hd)]
    xd = dirs if mode == kf.FULL else None
    dw = _host_bwd(lib, raw, p, mode, x, xd, g, d, 256 if need_dw else 0, 2)
    plain = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    want = plain(p, mode, x, xd, *g, need_dw=need_dw)
    _scaled_close(d[0], want[0], 1e-5, "d_x")
    if mode == kf.FULL:
        _scaled_close(d[1], want[1], 1e-5, "d_dirs")
    if need_dw:
        nw = p.w.numel()
        _scaled_close(dw[:nw], want[2][:nw], 1e-5, "dW")
        _scaled_close(dw[nw:], want[2][nw:], 1e-5, "db")


# 300 rows with dW in chunks of 64 (every chunk half a block tile, the
# last of 44 rows) and of 192 (the second chunk of 108 rows starts at row
# 192, mid block tile of the rows, and ends mid its second block tile)
@pytest.mark.parametrize("mode", [kf.SIGMA, kf.FULL], ids=["sigma", "full"])
@pytest.mark.parametrize("raw,chunk,slices", [
    pytest.param(False, 64, 1, id="float32-chunks-of-64"),
    pytest.param(True, 64, 2, id="raw-float32-chunks-of-64"),
    pytest.param(False, 192, 2, id="float32-chunks-of-192")])
def test_field_bwd_warp_chunks_mid_tile(raw, chunk, slices, mode,
                                        host_build):
    """K2/K6 with dW in sigma and full mode over chunks that end in the
    middle of a 128-row block tile, against the plain version to the
    scaled 1e-5; then the same chunks on a persistent grid of 2 blocks and
    on one block per block tile, and a second call, all bit for bit the
    same as the first call (the host build's own grid: one block)."""
    spec, p, gen = _emulated_case()
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    N, nw = 300, p.w.numel()
    x, dirs, hd, (dx_w, dd_w) = _inputs(gen, spec, N, raw)
    g = _cotangents(gen, N, spec.feature_dim, hd)

    def run(blocks):
        d = [torch.empty((N, dx_w), dtype=hd),
             torch.empty((N, dd_w), dtype=hd)]
        dw = _host_bwd(lib, raw, p, mode, x, dirs, g, d, chunk, slices,
                       blocks)
        return [dw, d[0]] + ([d[1]] if mode == kf.FULL else [])

    first = run(None)
    plain = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    want = plain(p, mode, x, dirs, *g, need_dw=True)
    _scaled_close(first[0][:nw], want[2][:nw], 1e-5, "dW")
    _scaled_close(first[0][nw:], want[2][nw:], 1e-5, "db")
    for o, w in zip(first[1:], want[:2]):
        _scaled_close(o, w, 1e-5)
    for blocks in (2, 0, None):
        for a, b in zip(first, run(blocks)):
            assert torch.equal(a, b), f"blocks={blocks}"


# the shared memory of one K2/K6 block of the warp path in full mode at
# D8/W128/F128, bf16 and f32 (PERF.md)
K2_SMEM_BYTES = {1: 208400, 0: 219664}


def test_field_bwd_warp_smem_fits_a_block(host_build):
    """The shared memory of one block of the backward K2/K6's warp path at
    the full-width ModelConfig() (the coarse tower) in sigma and full
    mode, bf16 and f32: within an H100 block's 232,448 bytes, sigma mode
    below full mode, full mode at the figures PERF.md states; one block
    an SM in the host build's answer."""
    from nefes_tpu_torch.train.model import ModelConfig
    lib = build.library("fused_field", emulate=True, build_dir=host_build)
    dims = kf.dims(kf.FieldSpec.from_model(ModelConfig(), "coarse"))
    smem = {(code, mode): lib.nefes_field_bwd_smem_bytes(code, mode, *dims)
            for code in (0, 1) for mode in (kf.SIGMA, kf.FULL)}
    assert all(0 < b <= BLOCK_SMEM_MAX for b in smem.values())
    for code in (0, 1):
        assert smem[code, kf.SIGMA] < smem[code, kf.FULL]
        assert smem[code, kf.FULL] == K2_SMEM_BYTES[code]
    assert lib.nefes_field_bwd_blocks_per_sm(1, kf.FULL, 0, *dims) == 1
    assert lib.nefes_field_bwd_blocks_per_sm(1, kf.TRANSIENT, 0, *dims) == -1


def test_build_of_another_tree(host_build, tmp_path):
    """build.library with csrc= compiles that tree's source alone into
    its own directory (how chip_smoke.py --parent builds an earlier
    fused_render.cu): a copy of csrc/ with one entry point added."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    with open(csrc / "fused_render.cu", "a") as f:
        f.write('\nextern "C" int nefes_tree_mark() { return 7; }\n')
    out = tmp_path / "build"
    lib = build.library("fused_render", emulate=True, build_dir=out,
                        csrc=csrc)
    assert lib.nefes_tree_mark() == 7
    assert [q.name.split("-")[0] for q in out.glob("*.so")] == [
        "libfused_render"]
    ours = build.library("fused_render", emulate=True, build_dir=host_build)
    assert not hasattr(ours, "nefes_tree_mark")


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda, dtype):
    """Each of K1-K8, and the training variants of K1/K2/K5/K6, against
    its plain version on the same card inputs (K3/K4/K7/K8 also at the
    full width and 384 samples a ray), by relative L2 error: bf16 1e-2,
    f32 1e-5. In bf16 the tensor cores
    and cuBLAS sum in another order, so a hidden unit within one rounding
    of 0 can fall on the other side of the ReLU, and a backward then
    passes or drops that unit's cotangent: single entries may differ by
    ~10 % while the tensor agrees."""
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    cfg = ModelConfig(depth=4, width=128, feature_dim=16, skips=(2,),
                      dtype=kf._DTYPES[dtype])
    model = NeFeSModel(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pc, pf = model.pack_fused()
    spec = pf.spec
    cd, tol = spec.torch_dtype, (1e-5 if dtype == "float32" else 1e-2)

    def agree(a, b):
        if b is None:
            assert a is None
            return
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
    # the training variants: transient mode, and the backward with dW in
    # every mode (the coarse tower for sigma and full), both input kinds
    T = kf.TRANSIENT
    gt = torch.randn((R * S, 5), device=cuda)
    for a, b in zip(kf.field_fwd(pf, T, pts, dirs),
                    kf.field_fwd_plain(pf, T, pts, dirs)):
        agree(a, b)
    for a, b in zip(kf.field_fwd_pre(pf, T, emb, embd),
                    kf.field_fwd_pre_plain(pf, T, emb, embd)):
        agree(a, b)
    for mode, p in ((kf.SIGMA, pc), (kf.FULL, pc), (T, pf)):
        for a, b in zip(kf.field_bwd(p, mode, pts, dirs, *g, gt, need_dw=True),
                        kf.field_bwd_plain(p, mode, pts, dirs, *g, gt,
                                           need_dw=True)):
            agree(a, b)
        gp = [v.to(cd) for v in (*g, gt)]
        for a, b in zip(kf.field_bwd_pre(p, mode, emb, embd, *gp,
                                         need_dw=True),
                        kf.field_bwd_pre_plain(p, mode, emb, embd, *gp,
                                               need_dw=True)):
            agree(a, b)
    # K3/K4/K7/K8 at the full-width ModelConfig() and 384 samples a ray:
    # the backward's per-sample state past a block's shared memory, in its
    # global scratch
    wide = NeFeSModel(ModelConfig(dtype=cd), device=cuda,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pw = wide.pack_fused()[1]
    sw, S = pw.spec, 384
    emb = torch.randn((R * S, sw.emb_xyz), device=cuda).to(cd)
    embd = torch.randn((R * S, sw.emb_dir), device=cuda).to(cd)
    pts = torch.randn((R * S, 3), device=cuda) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn((R * S, 3),
                                                     device=cuda), dim=-1)
    z = torch.sort(torch.rand((R, S), device=cuda) * 4, 1).values
    gr = torch.randn((R, sw.rgbfeat + 2), device=cuda)
    for x, xd, fwd, fwd_plain, bwd, bwd_plain in (
            (emb, embd, kr.render_fwd_pre, kr.render_fwd_pre_plain,
             kr.render_bwd_pre, kr.render_bwd_pre_plain),
            (pts, dirs, kr.render_fwd, kr.render_fwd_plain, kr.render_bwd,
             kr.render_bwd_plain)):
        agree(fwd(pw, x, xd, z), fwd_plain(pw, x, xd, z))
        for a, b in zip(bwd(pw, x, xd, z, gr), bwd_plain(pw, x, xd, z, gr)):
            agree(a, b)
    torch.cuda.synchronize()
