"""The probe's micro-benchmark kernels, the ablations of the fused field
(runtime/probe.py kernelmicro), as hand-written Hopper kernels
(csrc/micro.cu) with a plain PyTorch version of each.

  K9  chain              replaces runtime/probe.py:cmd_kernelmicro's
                         run_chain (chain_kernel): a bare 8-layer chain
                         relu(bf16(h @ W_i)), f32 accumulation, 64 -> 128
                         then 128 -> 128
  K10 chain_interleaved  replaces run_chain_interleaved: the same chain
                         over n_blocks independent sub-tiles, every
                         sub-tile's layer-i products issued before any
                         layer i+1; K9's values
  K11 embed_micro        replaces the embed-only kernel: [sin(xs), cos(xs),
                         0 x 4] of xs = [x · 2^k for k < 10] band-major,
                         (N, 3) f32 -> (N, 64)
  K12 chain_sq           replaces make_sq (chain_sq_kernel): 8 square
                         layers of width 128 or 256

`tile` is the rows one block takes (the Pallas grid step), walked in
sub-tiles of TILE_ROWS; N must be a multiple of it. On the card the
wrappers run bf16, the probe's type (the source's f32 instantiation
serves the host build's tests). Each wrapper runs its kernel for a CUDA
tensor and the plain version for a CPU tensor, and counts kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels.fused_field import (
    _DTYPE_CODE, TILE_ROWS, _kernel_device, _stream, check, raise_on,
)

BF16 = _DTYPE_CODE[torch.bfloat16]

EMBED_BANDS = 10       # phases x · 2^0 .. x · 2^9
EMBED_COLS = 64        # 30 sines, 30 cosines, 4 zero columns


@dataclass(frozen=True)
class ChainWeights:
    """The D matrices of a chain, (E, W) then (W, W), (in, out), and the
    same flattened into one blob, as the kernel reads them."""

    ws: tuple
    w: torch.Tensor

    @property
    def E(self) -> int:
        return self.ws[0].shape[0]

    @property
    def W(self) -> int:
        return self.ws[0].shape[1]

    @property
    def D(self) -> int:
        return len(self.ws)


def pack_chain(ws) -> ChainWeights:
    ws = tuple(ws)
    for w in ws[1:]:
        if tuple(w.shape) != (ws[0].shape[1],) * 2:
            raise ValueError("a chain's layers after the first are square")
    return ChainWeights(ws, torch.cat([w.reshape(-1) for w in ws]))


def chain_plain(cw: ChainWeights, x: torch.Tensor) -> torch.Tensor:
    """K9's, K10's and K12's function: each layer accumulates in f32,
    rounds to x's type, then takes the ReLU."""
    h = x
    for w in cw.ws:
        h = (h.float() @ w.float()).to(x.dtype).clamp_min(0)
    return h


def embed_micro_plain(pts: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K11's function: pts (N, 3) f32 -> (N, 64) in dtype."""
    xs = torch.cat([pts.float() * 2.0 ** k for k in range(EMBED_BANDS)], 1)
    zeros = xs.new_zeros(xs.shape[0], EMBED_COLS - 2 * xs.shape[1])
    return torch.cat([torch.sin(xs), torch.cos(xs), zeros], 1).to(dtype)


def _check_tile(n: int, tile: int, rows: int) -> None:
    if tile <= 0 or tile % rows or n % tile:
        raise ValueError(f"tile {tile} must be a multiple of {rows} rows "
                         f"that divides N = {n}")


def _chain(wrapper, cw: ChainWeights, x: torch.Tensor, tile: int,
           n_blocks: int) -> torch.Tensor:
    n = x.shape[0]
    _check_tile(n, tile, n_blocks * TILE_ROWS)
    if not _kernel_device(x):
        return chain_plain(cw, x)
    dev, bf = x.device, torch.bfloat16
    check(x, "x", (n, cw.E), bf, dev)
    check(cw.w, "w", (cw.E * cw.W + (cw.D - 1) * cw.W ** 2,), bf, dev)
    out = torch.empty((n, cw.W), dtype=bf, device=dev)
    err = build.library("micro").nefes_micro_chain(
        BF16, n, tile, n_blocks, cw.E, cw.W, cw.D, x.data_ptr(),
        cw.w.data_ptr(), out.data_ptr(), _stream())
    wrapper.launches += 1
    raise_on(err, wrapper.__name__)
    return out


def chain(cw: ChainWeights, x: torch.Tensor, tile: int) -> torch.Tensor:
    """K9: the chain over x (N, E), `tile` rows a block; (N, W)."""
    return _chain(chain, cw, x, tile, 1)


def chain_interleaved(cw: ChainWeights, x: torch.Tensor, tile: int,
                      n_blocks: int) -> torch.Tensor:
    """K10: K9 with n_blocks sub-tiles of TILE_ROWS issued layer by layer
    together; tile a multiple of n_blocks · TILE_ROWS."""
    return _chain(chain_interleaved, cw, x, tile, n_blocks)


def chain_sq(cw: ChainWeights, x: torch.Tensor, tile: int) -> torch.Tensor:
    """K12: a chain of square layers (W, W) over x (N, W)."""
    if cw.E != cw.W:
        raise ValueError("chain_sq takes square layers")
    return _chain(chain_sq, cw, x, tile, 1)


def embed_micro(pts: torch.Tensor, tile: int) -> torch.Tensor:
    """K11: pts (N, 3) f32 -> (N, 64) bf16, `tile` rows a block."""
    n = pts.shape[0]
    _check_tile(n, tile, 1)
    if not _kernel_device(pts):
        return embed_micro_plain(pts)
    check(pts, "pts", (n, 3), torch.float32, pts.device)
    out = torch.empty((n, EMBED_COLS), dtype=torch.bfloat16,
                      device=pts.device)
    err = build.library("micro").nefes_micro_embed(
        BF16, n, tile, pts.data_ptr(), out.data_ptr(),
        _stream())
    embed_micro.launches += 1
    raise_on(err, "embed_micro")
    return out


for _k in (chain, chain_interleaved, embed_micro, chain_sq):
    _k.launches = 0
