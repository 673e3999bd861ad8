"""tiny-cuda-nn checkpoint converter for the hash-grid field; port of
nefes_tpu/features/convert_tcnn.py (numpy only).

The reference's script/models/nerfh_tcnn.py keeps its weights as tcnn
packed buffers: ``encoder.params`` (the multiresolution hash tables, one
level after another at 8-aligned offsets) and ``{sigma,color,
transient_color}_net.params`` (FullyFusedMLP buffers: row-major per layer,
widths padded to 16, no biases; the padded input columns act as a bias
against tcnn's padding of the input vector with ones).

Targets fields/hashgrid.py's NeRFHTcnn(tcnn_exact=True) (tcnn's level
scales and resolutions, the half-cell offset, x-fastest dense order,
8-aligned tables), so converted tables index the same rows.
convert_nerfh_tcnn returns the flax-layout tree the JAX converter
returns; nerfh_tcnn_state_dict the port module's state dict.
"""

from __future__ import annotations

import numpy as np

from nefes_tpu_torch.fields.hashgrid import level_layout
from nefes_tpu_torch.weights import zoo_from_jax_variables


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def unpack_tcnn_mlp(buf: np.ndarray, n_input: int, width: int,
                    n_hidden_layers: int, n_output: int,
                    names: list[str]) -> dict:
    """A FullyFusedMLP packed buffer -> {name: {kernel (in, out), bias}}.
    names: the hidden layers' names (n_hidden_layers of them), then the
    output layer's."""
    in_pad = _ceil_mult(n_input, 16)
    out_pad = _ceil_mult(n_output, 16)
    sizes = ([width * in_pad] + [width * width] * (n_hidden_layers - 1)
             + [out_pad * width])
    assert buf.size == sum(sizes), (buf.size, sizes)
    assert len(names) == n_hidden_layers + 1
    chunks = np.split(buf.astype(np.float32), np.cumsum(sizes)[:-1])
    params = {}
    w0 = chunks[0].reshape(width, in_pad)
    params[names[0]] = {"kernel": w0[:, :n_input].T,
                        "bias": w0[:, n_input:].sum(-1)}
    for i in range(1, n_hidden_layers):
        params[names[i]] = {"kernel": chunks[i].reshape(width, width).T,
                            "bias": np.zeros(width, np.float32)}
    wo = chunks[-1].reshape(out_pad, width)
    params[names[-1]] = {"kernel": wo[:n_output].T,
                         "bias": np.zeros(n_output, np.float32)}
    return params


def tcnn_level_layout(n_levels: int = 16, features: int = 2,
                      log2_table: int = 19, base: int = 16,
                      max_resolution: int = 2048):
    """(resolutions, table rows, offsets) of a tcnn GridEncoding: the
    levels of HashGridEncoding(tcnn_exact=True)."""
    res, _, sizes = level_layout(n_levels, log2_table, base, max_resolution,
                                 tcnn_exact=True)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return list(res), list(sizes), offsets


def unpack_hashgrid(buf: np.ndarray, n_levels: int = 16, features: int = 2,
                    log2_table: int = 19, base: int = 16,
                    max_resolution: int = 2048) -> dict:
    """An encoder.params buffer -> {level_<l>: (rows, features)}."""
    _, _, offsets = tcnn_level_layout(n_levels, features, log2_table, base,
                                      max_resolution)
    assert buf.size == offsets[-1] * features, (buf.size,
                                                offsets[-1] * features)
    flat = buf.astype(np.float32).reshape(-1, features)
    return {f"level_{l}": flat[offsets[l]:offsets[l + 1]]
            for l in range(n_levels)}


def convert_nerfh_tcnn(sd: dict, hash_level: int = 16,
                       geo_features: int = 15, hidden: int = 64,
                       in_channels_a: int = 5, in_channels_t: int = 2,
                       transient: bool = True) -> dict:
    """The reference NeRF_TCNN tower's state dict (packed tcnn buffers,
    keys encoder.params, sigma_net.params, color_net.params,
    transient_color_net.params; nerfh_tcnn.py:65-149) -> {"params": the
    flax-layout tree of NeRFHTcnn}."""
    params: dict = {"encoder": unpack_hashgrid(sd["encoder.params"],
                                               n_levels=hash_level)}
    params.update(unpack_tcnn_mlp(
        sd["sigma_net.params"], n_input=hash_level * 2, width=hidden,
        n_hidden_layers=1, n_output=1 + geo_features,
        names=["sigma_hidden", "sigma_out"]))
    params.update(unpack_tcnn_mlp(
        sd["color_net.params"],
        n_input=geo_features + 16 + in_channels_a, width=hidden,
        n_hidden_layers=2, n_output=3,
        names=["color_hidden0", "color_hidden1", "color_out"]))
    if transient and "transient_color_net.params" in sd:
        params.update(unpack_tcnn_mlp(
            sd["transient_color_net.params"],
            n_input=geo_features + 16 + in_channels_t, width=hidden,
            n_hidden_layers=3, n_output=5,
            names=["transient_hidden0", "transient_hidden1",
                   "transient_hidden2", "transient_out"]))
    return {"params": params}


def nerfh_tcnn_state_dict(sd: dict, **kw) -> dict:
    """convert_nerfh_tcnn as the state dict of the port's
    NeRFHTcnn(tcnn_exact=True) of the same widths (kw as
    convert_nerfh_tcnn's)."""
    return zoo_from_jax_variables(convert_nerfh_tcnn(sd, **kw))
