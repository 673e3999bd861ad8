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

`tile` is the rows of a unit of work (the Pallas grid step), which a
persistent grid of CTAs walks; N must be a multiple of it, and for the
chains tile a multiple of TILE_ROWS (a wgmma m-tile). The chain kernel
(wgmma, weights streamed by cp.async.bulk) reads its weights as
pack_chain lays them out: per layer, K-slices of CHAIN_KS inputs by W
outputs, each the K-major 128-byte-swizzled B operand, the last layer's
outputs permuted (chain_out_col) for 16-byte stores. n_blocks (K10) is
the 64-row m-tiles in flight against each weight slice (2 or 4); K9 and
K12 take the most the registers hold. The chains take the probe's shapes
(check_chain_shape). On the card the wrappers run bf16, the probe's type
(the source's f32 build serves the host build's tests). Each wrapper
runs its kernel for a CUDA tensor and the plain version for a CPU
tensor, and counts kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from nefes_tpu_torch.kernels import build
from nefes_tpu_torch.kernels.fused_field import (
    _DTYPE_CODE, TILE_ROWS, _kernel_device, _stream, check, raise_on,
)

BF16 = _DTYPE_CODE[torch.bfloat16]

EMBED_BANDS = 10       # phases x · 2^0 .. x · 2^9
EMBED_COLS = 64        # 30 sines, 30 cosines, 4 zero columns
CHAIN_KS = 64          # inputs of a weight slice (csrc/micro.cu CHAIN_KS)


@dataclass(frozen=True)
class ChainWeights:
    """The D matrices of a chain, (E, W) then (W, W), (in, out), and the
    same packed into one blob in the kernel's order (pack_chain)."""

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


def chain_out_col(p: torch.Tensor) -> torch.Tensor:
    """The last layer's output column at accumulator position p = 32 q +
    8 jj + 2 t + e: 32 q + 8 t + 2 jj + e (csrc/micro.cu chain_out_col),
    so that a thread holds 8 consecutive columns. Its own inverse."""
    return (p & ~31) | ((p & 6) << 2) | ((p >> 2) & 6) | (p & 1)


def check_chain_shape(E: int, W: int, n_blocks: int = 1) -> None:
    """The shapes the chain kernel takes (csrc/micro.cu chain_shape_ok):
    the probe's, E = W = 128 or 256, or E = 64 and W = 128; n_blocks 1, 2
    or (W = 128) 4."""
    if (W not in (128, 256) or not (E == W or (E, W) == (64, 128))
            or n_blocks not in (1, 2, 4) or (n_blocks == 4 and W > 128)):
        raise ValueError(f"the chain kernel takes E = W = 128 or 256, or E "
                         f"= 64 and W = 128, and n_blocks 1, 2 or (W = 128) "
                         f"4; got E = {E}, W = {W}, n_blocks = {n_blocks}")


def pack_chain(ws) -> ChainWeights:
    """The chain's blob: layer by layer, K-slices of CHAIN_KS inputs by W
    outputs, each CHAIN_KS x W values stored as W rows (an output p) of 8
    chunks of 8 inputs, chunk c at c ^ (p % 8): the K-major
    128-byte-swizzled layout of a wgmma B operand. Row p of the last
    layer holds output column chain_out_col(p)."""
    ws = tuple(ws)
    E, W = ws[0].shape
    for w in ws[1:]:
        if tuple(w.shape) != (W, W):
            raise ValueError("a chain's layers after the first are square")
    check_chain_shape(E, W)
    parts = []
    for i, w in enumerate(ws):
        K = w.shape[0]
        if i == len(ws) - 1:
            w = w[:, chain_out_col(torch.arange(W, device=w.device))]
        # (K, W) -> (slice, p, chunk, 8): the value of input k = 64 s + 8 c +
        # j for output p, then the chunks of each row swizzled
        blk = w.reshape(K // CHAIN_KS, 8, 8, W).permute(0, 3, 1, 2)
        c = torch.arange(8, device=w.device)
        src = c[None, :] ^ (torch.arange(W, device=w.device)[:, None] % 8)
        parts.append(blk.gather(2, src[None, :, :, None].expand(
            K // CHAIN_KS, W, 8, 8)).reshape(-1))
    return ChainWeights(ws, torch.cat(parts))


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
    _check_tile(n, tile, TILE_ROWS)
    check_chain_shape(cw.E, cw.W, n_blocks)
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


def chain_grid(cw: ChainWeights, n: int, tile: int, n_blocks: int = 1) -> int:
    """The CTAs the chain kernel launches on the current card for n rows:
    the lesser of the units (n / tile) and the resident CTAs."""
    grid = build.library("micro").nefes_micro_chain_grid(
        BF16, n, tile, n_blocks, cw.E, cw.W)
    if grid <= 0:
        raise ValueError(f"chain_grid: error {grid}")
    return grid


def embed_grid(n: int, tile: int) -> tuple[int, int]:
    """(CTAs, rows of a piece) the embedding launches on the current card
    for n rows in units of tile."""
    rows = ctypes.c_int(0)
    grid = build.library("micro").nefes_micro_embed_grid(
        BF16, n, tile, ctypes.byref(rows))
    if grid <= 0:
        raise ValueError(f"embed_grid: error {grid}")
    return grid, rows.value


def chain(cw: ChainWeights, x: torch.Tensor, tile: int) -> torch.Tensor:
    """K9: the chain over x (N, E) in units of `tile` rows; (N, W)."""
    return _chain(chain, cw, x, tile, 1)


def chain_interleaved(cw: ChainWeights, x: torch.Tensor, tile: int,
                      n_blocks: int) -> torch.Tensor:
    """K10: K9 with n_blocks m-tiles of TILE_ROWS rows in flight against
    each weight slice, layer by layer together (2, or 4 at W = 128)."""
    return _chain(chain_interleaved, cw, x, tile, n_blocks)


def chain_sq(cw: ChainWeights, x: torch.Tensor, tile: int) -> torch.Tensor:
    """K12: a chain of square layers (W, W) over x (N, W)."""
    if cw.E != cw.W:
        raise ValueError("chain_sq takes square layers")
    return _chain(chain_sq, cw, x, tile, 1)


def embed_micro(pts: torch.Tensor, tile: int) -> torch.Tensor:
    """K11: pts (N, 3) f32 -> (N, 64) bf16 in units of `tile` rows."""
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
