"""The field zoo's modules (nefes_tpu_torch/fields/activation.py,
hashgrid.py, legacy.py, decoder.py) against the JAX package's, on the CPU
in f32, the JAX weights carried across with weights.zoo_from_jax_variables.

Tolerances: values to 1e-5 (relative and absolute); gradients, the hash
tables' included, to 1e-4 of their largest entry. The hash encoding is
held in both layouts (the default and tcnn_exact) at levels that index
densely and levels that hash (the uint32 spatial hash with wraparound),
at random points and at x01 exactly 0 and 1 (the clamped base cell).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.fields import activation as jact
from nefes_tpu.fields import decoder as jdec
from nefes_tpu.fields import hashgrid as jhash
from nefes_tpu.fields import legacy as jleg
from nefes_tpu_torch.fields import activation as tact
from nefes_tpu_torch.fields import decoder as tdec
from nefes_tpu_torch.fields import hashgrid as thash
from nefes_tpu_torch.fields import legacy as tleg
from nefes_tpu_torch.weights import zoo_from_jax_variables
from tests.torch_parity import close, n, t

RNG = np.random.default_rng(16)
VAL, GRAD = 1e-5, 1e-4


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _port(tmod, variables):
    tmod.load_state_dict(zoo_from_jax_variables(_np_tree(variables)))
    return tmod


def _scaled_close(got, want, tol, msg=""):
    scale = max(float(np.abs(n(want)).max()), 1e-12)
    np.testing.assert_allclose(n(got) / scale, n(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


def _check(jfn, jvars, tmod, jinputs, tcall, heads=None):
    """Every output of the JAX module jfn(variables, *inputs) against the
    port module's tcall(*inputs), values to VAL; then the gradient of a
    random weighting of every output w.r.t. every parameter and input,
    to GRAD of its scale."""
    want = jfn(jvars, *jinputs)
    tin = [t(x, requires_grad=True) if x is not None else None
           for x in jinputs]
    got = tcall(*tin)
    if not isinstance(want, dict):
        want, got = {"out": want}, {"out": got}
    assert set(got) == set(want if heads is None else heads)
    cot = {k: RNG.normal(size=np.shape(v)).astype(np.float32)
           for k, v in want.items()}
    for k in want:
        close(got[k], want[k], VAL, VAL, k)

    def loss(v, *xs):
        out = jfn(v, *xs)
        out = out if isinstance(out, dict) else {"out": out}
        return sum(jnp.sum(out[k] * cot[k]) for k in cot)
    jg = jax.grad(loss, argnums=tuple(range(1 + len(jinputs))))(
        jvars, *[jnp.asarray(x) if x is not None else None
                 for x in jinputs])
    torch.autograd.backward([got[k] for k in cot],
                            [t(cot[k]) for k in cot])
    want_g = zoo_from_jax_variables(_np_tree(jg[0]))
    for name, p in tmod.named_parameters():
        _scaled_close(p.grad, want_g[name], GRAD, name)
    for x, g in zip(tin, jg[1:]):
        if x is not None:
            _scaled_close(x.grad, g, GRAD, "input")


def test_trunc_exp_value_and_clamped_grad():
    x = np.array([-20.0, -1.0, 0.0, 1.0, 14.0, 20.0], np.float32)
    tx = t(x, requires_grad=True)
    y = tact.trunc_exp(tx)
    close(y, jact.trunc_exp(jnp.asarray(x)), VAL, 0)
    y.sum().backward()
    jg = jax.grad(lambda v: jact.trunc_exp(v).sum())(jnp.asarray(x))
    close(tx.grad, jg, VAL, 0)
    assert float(tx.grad[-1]) == pytest.approx(np.exp(15.0), rel=1e-6)
    tx.grad = None
    tact.trunc_softplus(tx).sum().backward()
    jg = jax.grad(lambda v: jact.trunc_softplus(v).sum())(jnp.asarray(x))
    close(tact.trunc_softplus(tx), jact.trunc_softplus(jnp.asarray(x)),
          VAL, VAL)
    close(tx.grad, jg, VAL, VAL)
    assert float(tx.grad[0]) == 0.0 and float(tx.grad[-1]) == 0.0


def test_spherical_harmonics_deg4():
    d = RNG.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(thash.spherical_harmonics_deg4(t(d)),
          jhash.spherical_harmonics_deg4(jnp.asarray(d)), VAL, VAL)


# (layout, levels, log2 table rows, base, max resolution): each with a
# dense first level and hashed ones after
GRIDS = {"default": (False, 3, 10, 4, 32), "tcnn_exact": (True, 3, 10, 4, 32)}


@pytest.mark.parametrize("layout", list(GRIDS))
def test_hash_encoding(layout):
    exact, L, log2_t, base, max_res = GRIDS[layout]
    kw = dict(n_levels=L, log2_table_size=log2_t, base_resolution=base,
              max_resolution=max_res, tcnn_exact=exact)
    tenc = thash.HashGridEncoding(**kw)
    res, sizes = tenc.resolutions, tenc.table_sizes
    dense = [s >= (r ** 3 if exact else (r + 1) ** 3)
             for r, s in zip(res, sizes)]
    assert dense[0] and not any(dense[1:]), (res, sizes)
    jenc = jhash.HashGridEncoding(**kw)
    x = RNG.uniform(0, 1, (64, 3)).astype(np.float32)
    # the faces of the cube: coordinates exactly 0 and exactly 1
    x[:8] = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25],
                      [0.5, 1, 1], [1, 0.5, 0], [0, 0, 1], [1, 1, 0]])
    jv = jenc.init(jax.random.key(1), jnp.asarray(x))
    # the tables at a visible scale: values, not rounding, are compared
    jv = jax.tree.map(lambda a: a * 1e3, jv)
    _port(tenc, jv)
    assert tenc.resolutions == tuple(jenc.bind(jv).resolutions)
    _check(jenc.apply, jv, tenc, [x], tenc)


def test_hash_encoding_default_size_hashes_with_wraparound():
    """At the field's own table size (2^19 rows, base 16 -> 2048) the
    finest level's corner coordinates reach 2047, so y·p1 and z·p2 wrap
    around 2^32: the rows the port gathers are the JAX package's."""
    kw = dict(n_levels=2, tcnn_exact=False)
    tenc, jenc = thash.HashGridEncoding(**kw), jhash.HashGridEncoding(**kw)
    x = RNG.uniform(0.9, 1.0, (256, 3)).astype(np.float32)
    jv = jax.tree.map(lambda a: a * 1e3,
                      jenc.init(jax.random.key(2), jnp.asarray(x)))
    _port(tenc, jv)
    assert tenc.resolutions == (16, 2047)       # floor(16·128^1), rounded
    assert tenc.resolutions == tuple(jenc.bind(jv).resolutions)
    close(tenc(t(x)), jenc.apply(jv, jnp.asarray(x)), VAL, VAL)
    c = torch.from_numpy(RNG.integers(1024, 2048, (500, 3)))
    got = tenc._index(c, 1)
    want = jenc.apply(jv, jnp.asarray(c.numpy(), jnp.uint32), 1,
                      method=jhash.HashGridEncoding._index)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("exact", [False, True])
def test_nerfh_tcnn_field(exact):
    kw = dict(bound=3.0, hash_level=3, tcnn_exact=exact)
    jm = jhash.NeRFHTcnn(encode_transient=True, **kw)
    tm = thash.NeRFHTcnn(encode_transient=True, in_channels_a=5,
                         in_channels_t=2, **kw)
    xyz = RNG.uniform(-2.5, 2.5, (6, 5, 3)).astype(np.float32)
    d = RNG.normal(size=(6, 5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = RNG.normal(size=(5,)).astype(np.float32)
    tl = RNG.normal(size=(6, 1, 2)).astype(np.float32)
    jv = jm.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(d),
                 jnp.asarray(a), jnp.asarray(tl), output_transient=True)
    jv = jax.tree.map(np.array, jv)
    for lvl in range(3):     # visible densities: tables off their 2e-4
        jv["params"]["encoder"][f"level_{lvl}"] *= 1e3
    _port(tm, jv)
    heads = ("static_sigma", "static_rgb", "static_feat", "transient_rgb",
             "transient_sigma", "transient_beta")

    def jfn(v, x, dd, aa, tt):
        out = jm.apply(v, x, dd, aa, tt, output_transient=True)
        return {k: w for k, w in out.items() if k != "static_feat"}

    def tcall(x, dd, aa, tt):
        out = tm(x, dd, aa, tt, output_transient=True)
        assert out["static_feat"].shape == (6, 5, 0)
        return {k: w for k, w in out.items() if k != "static_feat"}
    _check(jfn, jv, tm, [xyz, d, a, tl], tcall)
    got = tm(t(xyz), t(d), t(a), t(tl), output_transient=True)
    assert set(got) == set(heads)
    assert set(tm(t(xyz), sigma_only=True)) == {"static_sigma"}


def test_plain_nerf():
    kw = dict(depth=3, width=16, skips=(1,), in_channels_xyz=9,
              in_channels_dir=6)
    jm, tm = jleg.PlainNeRF(**kw), tleg.PlainNeRF(**kw)
    x = RNG.normal(size=(4, 7, 9)).astype(np.float32)
    d = RNG.normal(size=(4, 7, 6)).astype(np.float32)
    jv = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(d))
    _port(tm, jv)

    def jfn(v, xx, dd):
        out = jm.apply(v, xx, dd)
        assert out["static_feat"].shape == (4, 7, 0)
        return {k: w for k, w in out.items() if k != "static_feat"}

    def tcall(xx, dd):
        out = tm(xx, dd)
        assert out["static_feat"].shape == (4, 7, 0)
        return {k: w for k, w in out.items() if k != "static_feat"}
    _check(jfn, jv, tm, [x, d], tcall)
    assert set(tm(t(x), sigma_only=True)) == {"static_sigma"}


@pytest.mark.parametrize("typ", ["coarse", "fine"])
def test_nerfw(typ):
    kw = dict(typ=typ, depth=3, width=16, skips=(1,), in_channels_xyz=9,
              in_channels_dir=6, in_channels_a=10, in_channels_t=4)
    jm, tm = jleg.NeRFW(**kw), tleg.NeRFW(**kw)
    x = RNG.normal(size=(4, 7, 9)).astype(np.float32)
    d = RNG.normal(size=(4, 7, 6)).astype(np.float32)
    a = RNG.normal(size=(4, 1, 10)).astype(np.float32)   # a latent a ray
    tl = RNG.normal(size=(4, 1, 4)).astype(np.float32)
    jv = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(d),
                 jnp.asarray(a), jnp.asarray(tl))
    _port(tm, jv)
    ins = [x, d] + ([a, tl] if typ == "fine" else [])

    def jfn(v, xx, dd, aa=None, tt=None):
        out = jm.apply(v, xx, dd, aa, tt, output_transient=True)
        return {k: w for k, w in out.items() if k != "static_feat"}

    def tcall(xx, dd, aa=None, tt=None):
        out = tm(xx, dd, aa, tt, output_transient=True)
        assert out["static_feat"].shape == (4, 7, 0)
        return {k: w for k, w in out.items() if k != "static_feat"}
    _check(jfn, jv, tm, ins, tcall)
    if typ == "fine":
        off = tm(t(x), t(d), t(a), t(tl), output_transient=False)
        assert "transient_rgb" not in off


@pytest.mark.parametrize("skip", [True, False])
def test_giraffe_decoder(skip):
    kw = dict(n_feat=16, input_dim=8, out_dim=3, min_feat=4, n_blocks=3,
              out_hw=(20, 26), use_rgb_skip=skip)
    jm, tm = jdec.GiraffeDecoder(**kw), tdec.GiraffeDecoder(**kw)
    x = RNG.normal(size=(2, 4, 5, 8)).astype(np.float32)
    jv = jm.init(jax.random.key(0), jnp.asarray(x))
    _port(tm, jv)
    _check(jm.apply, jv, tm, [x], tm)
    if skip:
        hier = tm(t(x), return_hier_rgbs=True)
        jhier = jm.apply(jv, jnp.asarray(x), return_hier_rgbs=True)
        for g, w in zip(hier, jhier):
            close(g, w, VAL, VAL, "hierarchical rgb")
    close(tdec.blur(t(x)), jdec.blur(jnp.asarray(x)), VAL, VAL, "blur")
