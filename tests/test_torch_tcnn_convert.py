"""The port's tiny-cuda-nn converter (nefes_tpu_torch/features/
convert_tcnn.py) against the JAX package's on synthetic packed buffers,
the cases of tests/test_tcnn_convert.py: the level layout, the MLP and
hash-grid unpacking (equal arrays), the full NeRF_TCNN tower converted
into the port's NeRFHTcnn(tcnn_exact=True), whose forward is held to the
JAX field on the JAX converter's tree (1e-5), and the port's tcnn-layout
grid against that test's independent numpy twin of tcnn's lookup."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefes_tpu.features import convert_tcnn as jconv
from nefes_tpu.fields.hashgrid import NeRFHTcnn as JNeRFHTcnn
from nefes_tpu_torch.features import convert_tcnn as tconv
from nefes_tpu_torch.fields.hashgrid import HashGridEncoding, NeRFHTcnn
from tests.test_tcnn_convert import numpy_tcnn_grid_lookup
from tests.torch_parity import close, t

RNG = np.random.default_rng(17)


def _tree_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("args", [(16, 2, 19, 16, 2048), (6, 2, 10, 4, 64),
                                  (3, 2, 12, 8, 512)])
def test_level_layout_matches_jax(args):
    got, want = tconv.tcnn_level_layout(*args), jconv.tcnn_level_layout(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    enc = HashGridEncoding(n_levels=args[0], log2_table_size=args[2],
                           base_resolution=args[3], max_resolution=args[4],
                           tcnn_exact=True)
    assert list(enc.table_sizes) == list(want[1])


def test_unpack_mlp_and_grid_match_jax():
    n_in, width, n_out = 10, 32, 12
    buf = RNG.normal(size=width * 16 + width * width + 16 * width)
    names = ["h0", "h1", "out"]
    _tree_equal(tconv.unpack_tcnn_mlp(buf, n_in, width, 2, n_out, names),
                jconv.unpack_tcnn_mlp(buf, n_in, width, 2, n_out, names))
    L, base, max_res, log2_t = 6, 4, 64, 10
    _, _, offsets = tconv.tcnn_level_layout(L, 2, log2_t, base, max_res)
    grid = RNG.normal(0, 1e-2, offsets[-1] * 2).astype(np.float32)
    tables = tconv.unpack_hashgrid(grid, L, 2, log2_t, base, max_res)
    _tree_equal(tables, jconv.unpack_hashgrid(grid, L, 2, log2_t, base,
                                              max_res))
    # the port's tcnn-layout grid on the converted tables: tcnn's lookup
    enc = HashGridEncoding(n_levels=L, log2_table_size=log2_t,
                           base_resolution=base, max_resolution=max_res,
                           tcnn_exact=True)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in tables.items()})
    x = RNG.uniform(0.01, 0.99, (64, 3)).astype(np.float32)
    want = numpy_tcnn_grid_lookup(x, tables, L, base, max_res, log2_t)
    close(enc(t(x)), want, 2e-5, 2e-6)


def test_convert_nerfh_tcnn_full_tower():
    L = 16
    _, _, offsets = tconv.tcnn_level_layout(L)
    sd = {
        "encoder.params": RNG.normal(0, 1e-1, offsets[-1] * 2
                                     ).astype(np.float32),
        "sigma_net.params": RNG.normal(0, 0.05, 64 * 32 + 16 * 64
                                       ).astype(np.float32),
        "color_net.params": RNG.normal(
            0, 0.05, 64 * 48 + 64 * 64 + 16 * 64).astype(np.float32),
        "transient_color_net.params": RNG.normal(
            0, 0.05, 64 * 48 + 2 * 64 * 64 + 16 * 64).astype(np.float32),
    }
    want = jconv.convert_nerfh_tcnn(sd)
    _tree_equal(tconv.convert_nerfh_tcnn(sd), want)
    model = NeRFHTcnn(tcnn_exact=True)
    model.load_state_dict(tconv.nerfh_tcnn_state_dict(sd))
    xyz = RNG.uniform(-20, 20, (7, 3)).astype(np.float32)
    d = RNG.normal(size=(7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a, tl = RNG.normal(size=5), RNG.normal(size=2)
    jout = JNeRFHTcnn(tcnn_exact=True).apply(
        jax.tree.map(jnp.asarray, want), jnp.asarray(xyz), jnp.asarray(d),
        jnp.asarray(a, jnp.float32), jnp.asarray(tl, jnp.float32),
        output_transient=True)
    with torch.no_grad():
        tout = model(t(xyz), t(d), t(a), t(tl), output_transient=True)
    assert set(tout) == set(jout)
    for k in jout:
        close(tout[k], jout[k], 1e-5, 1e-5, k)
    assert float(tout["static_sigma"].abs().max()) > 0
