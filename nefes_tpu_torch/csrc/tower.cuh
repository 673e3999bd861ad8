// Shared device code of the NeRFH-NFF tower kernels: the dims, layout and
// embedding every kernel reads, the dW operands' slot layout, and the
// first design's block path, which fused_field.cu's field_bwd_kernel
// (K2/K6 in transient mode, with or without the weight gradients) and
// micro.cu's chains run: the MLP tower's forward (and the NeRF-W
// transient branch), recomputed, and its backward, over one tile of TR
// samples per block, fed either pre-embedded rows or raw f32 points and
// directions that the tile embeds itself (the raw-input K6). The forwards
// K1/K5 in every mode, the backwards K2/K6 in sigma and full mode and the
// render kernels K3/K4/K7/K8 run render_bwd.cuh's warp path instead.
//
// Replaces the per-tile bodies of the Pallas kernels in
// nefes_tpu/kernels/fused_field.py (_embed_block, _tower_tile,
// _mlp_backward, pre=True or False, need_dw=True or False). Same
// arithmetic and the same rounding points: hidden layers accumulate in
// f32 and round to the pack dtype T, then take the bias and the ReLU in
// T; heads accumulate in f32; a weight gradient is act^T · g with act in
// T and g rounded to T, accumulated in f32, a bias gradient the f32 sum
// of g (_mlp_backward's dmat).
//
// Weight gradients across tiles: the TPU grid runs in order and carries
// dW in VMEM from one tile to the next. A GPU grid does not, so the
// backward with dW (need_dw) runs over chunks of rows, one block per tile
// as without dW: each block writes its tile's dW operands to the chunk's
// row-major buffers in global memory (every layer input, A, in T, and
// every layer output cotangent, G, rounded to T; the slots below) and the
// head biases' gradients over the tile (f32 sums of their unrounded
// cotangents) to its own row of a per-tile f32 buffer. field_dw.cuh's
// kernel then contracts each product A^T G over the chunk's rows, the
// other biases as column sums of G. No atomics and fixed orders
// throughout, so the gradient and a training run's loss curve are the
// same from run to run.
//
// Design on Hopper (H100): the TPU kernel keeps the whole tower resident
// in VMEM. Here the weights (about 167k values for the fine tower, 333 KB
// in bf16) do not fit a block's 227 KB of shared memory, so they are read
// straight from global memory through L1/L2 (every block of the grid reads
// the same few hundred KB, which stays in the 50 MB L2), while one tile of
// activations lives in shared memory as f32 values that hold T-rounded
// numbers. The work is bound by operations (about 0.33 MFLOP per sample
// and direction). bf16 products run on the tensor cores with mma.sync
// (f32 accumulation, rounded in the epilogue as before); f32 products run
// on the CUDA cores, each thread computing 4x4 micro-tiles with FMA. This
// first version is far from the bound: the A fragments are rebuilt from
// f32 shared memory with bank conflicts and the B fragments come from L1.
// The render kernels (K3/K4, K7/K8), K1/K5 in every mode and K2/K6 in
// sigma and full mode no longer use this path: render_bwd.cuh runs their
// products per warp from bf16 tiles with the weights staged in shared
// memory (the render backward's forward once per sample). Still on it:
// K2/K6 in transient mode, the forward they recompute and their backward
// to the inputs.
//
// The field backward stores no activations: it recomputes the forward for
// the tile and keeps one ReLU bit per unit and layer, plus the dir-layer
// output and the sigma pre-activation (and, in transient mode, the three
// 64-wide transient layers and their head pre-activations). With dW it
// also writes the dW operands out as it goes (6,160 B a row in bf16 at
// D8/W128/F128 in transient mode), by streaming stores (store8).
//
// Host emulation: built with NEFES_EMULATE (see host_emulation.h) the same
// code runs on the CPU with one thread per block, so the arithmetic and
// the indexing can be checked without a card. That build takes f32 only:
// bf16 runs on the tensor cores, which exist only on the card, so its
// entry points refuse bf16 there (HAS_BF16) and bf16 is checked on the card.

#pragma once

#include <type_traits>

#ifdef NEFES_EMULATE
#include "host_emulation.h"
namespace nefes { constexpr bool HAS_BF16 = false; }
#else
namespace nefes { constexpr bool HAS_BF16 = true; }
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define NEFES_LAUNCH(kern, grid, smem, stream, ...) \
  kern<<<(grid), nefes::NT, (smem), static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__)
#endif

#include <stdint.h>

namespace nefes {

constexpr int NT = 256;       // threads per block
constexpr int TR = 64;        // samples per tower tile
constexpr int MAX_DEPTH = 16;
constexpr float LOG_EPS = 1e-10f;   // transmittance log floor
constexpr float DELTA_INF = 1e2f;   // compositor tail delta

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to the pack dtype and back
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Modes of the field kernels: the sigma head only; sigma plus the rgb and
// feature heads; and those plus the transient heads (fine tower, NeRF-W).
enum Mode { SIGMA = 0, FULL = 1, TRANSIENT = 2 };

// Tower dimensions (FieldSpec) and the offsets of every matrix and bias in
// the packed blobs. Matrices are (in, out) row-major in weight_names order;
// the transposed blob holds each one as (out, in) at the same offset. The
// transient arrays come after every static one, so a tower packed with
// them keeps the static offsets the render kernels read.
struct Dims {
  int depth, width, skipmask, E, Ed, F;
};

struct Layout {
  int we[MAX_DEPTH], wh[MAX_DEPTH], b[MAX_DEPTH];
  int sig_w, fin_w, dir_wh, dir_wd, rgb_w;
  int sig_b, fin_b, dir_b, rgb_b;
  int t1_wh, t1_wd, t2_w, t3_w, ts_w, tr_w, tb_w;
  int t1_b, t2_b, t3_b, ts_b, tr_b, tb_b;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  const int W = d.width, H = d.width / 2, C = 3 + d.F;
  int w = 0, b = 0;
  for (int i = 0; i < d.depth; ++i) {
    L.we[i] = L.wh[i] = -1;
    if (i == 0) {
      L.we[i] = w; w += d.E * W;
    } else if ((d.skipmask >> i) & 1) {
      L.we[i] = w; w += d.E * W;
      L.wh[i] = w; w += W * W;
    } else {
      L.wh[i] = w; w += W * W;
    }
    L.b[i] = b; b += W;
  }
  L.sig_w = w; w += W;
  L.sig_b = b; b += 1;
  L.fin_w = w; w += W * W;
  L.fin_b = b; b += W;
  L.dir_wh = w; w += W * H;
  L.dir_wd = w; w += d.Ed * H;
  L.dir_b = b; b += H;
  L.rgb_w = w; w += H * C;
  L.rgb_b = b; b += C;
  L.t1_wh = w; w += W * H;
  L.t1_wd = w; w += d.Ed * H;
  L.t2_w = w; w += H * H;
  L.t3_w = w; w += H * H;
  L.ts_w = w; w += H;
  L.tr_w = w; w += H * 3;
  L.tb_w = w;
  L.t1_b = b; b += H;
  L.t2_b = b; b += H;
  L.t3_b = b; b += H;
  L.ts_b = b; b += 1;
  L.tr_b = b; b += 3;
  L.tb_b = b;
  return L;
}

template <typename T>
struct Tower {
  const T* w;       // matrices, (in, out)
  const T* wt;      // the same matrices transposed, (out, in); backward only
  const float* b;   // biases
  Dims d;
  Layout L;
};

template <typename T>
Tower<T> make_tower(const void* w, const void* wt, const float* b, Dims d) {
  Tower<T> tw;
  tw.w = static_cast<const T*>(w);
  tw.wt = static_cast<const T*>(wt);
  tw.b = b;
  tw.d = d;
  tw.L = make_layout(d);
  return tw;
}

__host__ __device__ constexpr int pad8(int x) { return (x + 7) & ~7; }

// The dW operands of one chunk of rows (the backward with dW): one
// row-major (rows, ld) buffer of T a slot, ld = pad8(columns) (so every
// row and every buffer starts 16-byte aligned; the padding holds zeros),
// the slots one after the other in this order, those a mode does not use
// left out. A side, a layer's input as the forward computed it: the
// embeddings, the dir layer's output, the transient layers t1..t3, the
// hidden layers h_0..h_{depth-1} and then `final` at A_H + depth. G side,
// a layer's output cotangent rounded to T: the sigma head's, final's, the
// dir layer's, the rgb/feature head's, the transient layers' and heads',
// and the hidden layers' at G_DZ + i.
enum DwSlot {
  A_EMB, A_EMBD, A_DE, A_T1, A_T2, A_T3,
  G_SIG, G_FIN, G_DIR, G_RGB, G_T1, G_T2, G_T3, G_TS, G_TR, G_TB,
  A_H,
  G_DZ = A_H + MAX_DEPTH + 1,
  N_SLOTS = G_DZ + MAX_DEPTH
};

// Columns of slot k in `mode` (0: not used).
__host__ __device__ inline int slot_cols(const Dims& d, int mode, int k) {
  const int W = d.width, H = W / 2;
  const bool heads = mode != SIGMA, tr = mode == TRANSIENT;
  if (k >= G_DZ) return k - G_DZ < d.depth ? W : 0;
  if (k >= A_H) return k - A_H < d.depth ? W : (k - A_H == d.depth && heads ? W : 0);
  switch (k) {
    case A_EMB: return d.E;
    case A_EMBD: return heads ? d.Ed : 0;
    case A_DE: case G_DIR: return heads ? H : 0;
    case G_SIG: return 1;
    case G_FIN: return heads ? W : 0;
    case G_RGB: return heads ? 3 + d.F : 0;
    case A_T1: case A_T2: case A_T3: case G_T1: case G_T2: case G_T3: return tr ? H : 0;
    case G_TS: case G_TB: return tr ? 1 : 0;
    case G_TR: return tr ? 3 : 0;
  }
  return 0;
}

// Row stride of slot k, and its offset in a chunk of `rows` rows.
__host__ __device__ inline int slot_ld(const Dims& d, int mode, int k) {
  return pad8(slot_cols(d, mode, k));
}

__host__ __device__ inline size_t slot_off(const Dims& d, int mode, int rows, int k) {
  size_t e = 0;
  for (int j = 0; j < k; ++j) e += slot_ld(d, mode, j);
  return e * rows;
}

// Elements of T one row of the chunk holds over every slot.
__host__ __device__ inline int dw_row_elems(const Dims& d, int mode) {
  return (int)slot_off(d, mode, 1, N_SLOTS);
}

// Shared-memory carve-up of one tower tile of the backward. All
// activations are f32 values that hold numbers already rounded to the pack
// dtype.
struct Smem {
  float* emb;       // TR x E
  float* embd;      // TR x Ed (its cotangent after tower_backward)
  float* h0;        // TR x W
  float* h1;        // TR x W
  float* de;        // TR x H  (dir-layer output; its cotangent in backward)
  float* zs;        // TR      sigma pre-activation
  float* dzs;       // TR      its cotangent
  float* demb;      // TR x E  the cotangent of emb
  uint32_t* mask;   // depth x TR x W/32 ReLU bits
  float* t1;        // TR x H  transient layers (their cotangents, in
  float* t2;        // TR x H  place)
  float* t3;        // TR x H
  float* tz;        // TR x 5  transient head pre-activations (cotangents)
  int* slots;       // 2 x N_SLOTS the dW slots' columns and offsets
};

// Next 16-byte aligned buffer of n 4-byte words at base + *off.
__host__ __device__ inline float* take(char* base, size_t* off, size_t n) {
  float* p = base ? reinterpret_cast<float*>(base + *off) : nullptr;
  *off += ((n * 4 + 15) / 16) * 16;
  return p;
}

// Carve the backward tile's buffers (transient mode) from `base`; returns
// the bytes used. With base == nullptr only the size is computed (host
// side).
__host__ __device__ inline size_t carve(const Dims& d, char* base, Smem* s) {
  const int W = d.width, H = d.width / 2;
  size_t off = 0;
  Smem t;
  t.emb = take(base, &off, (size_t)TR * d.E);
  t.embd = take(base, &off, (size_t)TR * d.Ed);
  t.h0 = take(base, &off, (size_t)TR * W);
  t.h1 = take(base, &off, (size_t)TR * W);
  t.de = take(base, &off, (size_t)TR * H);
  t.zs = take(base, &off, TR);
  t.dzs = take(base, &off, TR);
  t.demb = take(base, &off, (size_t)TR * d.E);
  t.mask = reinterpret_cast<uint32_t*>(take(base, &off, (size_t)d.depth * TR * (W / 32)));
  t.slots = reinterpret_cast<int*>(take(base, &off, 2 * N_SLOTS));
  t.t1 = take(base, &off, (size_t)TR * H);
  t.t2 = take(base, &off, (size_t)TR * H);
  t.t3 = take(base, &off, (size_t)TR * H);
  t.tz = take(base, &off, (size_t)TR * 5);
  if (s) *s = t;
  return off;
}

// The slots' table of one block: t[k] slot k's columns, t[N_SLOTS + k]
// its offset in a chunk of one row (elements). One thread; the caller's
// next barrier publishes it.
__device__ inline void dw_table(const Dims& d, int mode, int* t) {
  if (threadIdx.x != 0) return;
  int e = 0;
  for (int k = 0; k < N_SLOTS; ++k) {
    t[k] = slot_cols(d, mode, k);
    t[N_SLOTS + k] = e;
    e += pad8(t[k]);
  }
}

// Where one tile of the backward with dW writes: the chunk's operand
// buffer (ops == nullptr for the frozen field, need_dw=False), the tile's
// row of nb f32 head bias sums (at the bias blob's offsets), the block's
// slot table (dw_table, in shared memory), the chunk's rows, the tile's
// first row in the chunk and its valid rows.
template <typename T>
struct DwOut {
  T* ops;
  float* part_b;
  const int* slots;
  int rows, row0, valid;
};

// Eight values to p[0..8) in T (p holds an element index of a row that is
// a multiple of 8), by streaming stores (st.global.cs: evict first). The
// operands pass through L2 once on their way out; stored as usual, they
// evicted the weights that every tile reads from L2, which cost K6 +dW
// 8.5 ms of 59 at the fine training pass on an H100 (PERF.md §6).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
#ifndef NEFES_EMULATE
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    auto pack = [](float a, float b) {
      __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      return *reinterpret_cast<uint32_t*>(&h);
    };
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7])));
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
#else
  for (int j = 0; j < 8; ++j) p[j] = from_f<T>(v[j]);
#endif
}

// Rows [0, valid) of the tile, column c < cols given by f(r, c) (an f32
// value, stored rounded to T), to slot k of the chunk at the tile's rows,
// the padding zero: a thread eight columns of a row at a time. No barrier.
template <typename T, typename Fn>
__device__ __forceinline__ void put_rows(const DwOut<T>& dw, int k, Fn f) {
  const int cols = dw.slots[k], ld = pad8(cols), units = ld / 8;
  T* dst = dw.ops + (size_t)dw.slots[N_SLOTS + k] * dw.rows + (size_t)dw.row0 * ld;
  for (int u = threadIdx.x; u < dw.valid * units; u += blockDim.x) {
    const int r = u / units, c = (u - r * units) * 8;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < cols ? f(r, c + j) : 0.f;
    store8(dst + (size_t)r * ld + c, v);
  }
}

// The same from a tile buffer of f32 values with row stride `cols`.
template <typename T>
__device__ __forceinline__ void put_tile(const DwOut<T>& dw, int k, const float* src) {
  const int cols = dw.slots[k];
  put_rows(dw, k, [=](int r, int c) { return src[r * cols + c]; });
}

#ifndef NEFES_EMULATE
// Tensor-core product for bf16: mma.sync m16n8k16 (bf16 in, f32
// accumulate). A warp owns a 16-row by (MMA_G x 8)-column block; the A
// fragment is built from A(r, k) (values already bf16-representable, so
// the conversion is exact) and reused across the block's n-tiles; B
// fragments are read from the (K, N) matrix through L1. K and N need not
// be multiples of 16 and 8: the ragged edge reads zeros.
constexpr int MMA_G = 4;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename AFn, typename Epi>
__device__ __forceinline__ void block_mm_mma(int K, int N,
                                             const __nv_bfloat16* __restrict__ B, int ldb,
                                             AFn A, Epi epi) {
  const unsigned short* Bu = reinterpret_cast<const unsigned short*>(B);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + 7) >> 3;
  const int items = (TR / 16) * ((n_tiles + MMA_G - 1) / MMA_G);
  auto a_at = [&](int r, int k) { return k < K ? A(r, k) : 0.f; };
  auto b_at = [&](int k, int n) -> uint32_t {
    return (k < K && n < N) ? Bu[(size_t)k * ldb + n] : 0u;
  };
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int r0 = (it % (TR / 16)) * 16 + g, r1 = r0 + 8;
    const int nt0 = (it / (TR / 16)) * MMA_G;
    float acc[MMA_G][4];
#pragma unroll
    for (int j = 0; j < MMA_G; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * t, kb = ka + 8;
      const uint32_t a[4] = {pack_bf16x2(a_at(r0, ka), a_at(r0, ka + 1)),
                             pack_bf16x2(a_at(r1, ka), a_at(r1, ka + 1)),
                             pack_bf16x2(a_at(r0, kb), a_at(r0, kb + 1)),
                             pack_bf16x2(a_at(r1, kb), a_at(r1, kb + 1))};
#pragma unroll
      for (int j = 0; j < MMA_G; ++j) {
        if (nt0 + j < n_tiles) {
          const int n = (nt0 + j) * 8 + g;
          mma_bf16(acc[j], a, b_at(ka, n) | (b_at(ka + 1, n) << 16),
                   b_at(kb, n) | (b_at(kb + 1, n) << 16));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MMA_G; ++j) {
      const int c = (nt0 + j) * 8 + 2 * t;
      if (nt0 + j < n_tiles) {
        if (c < N) { epi(r0, c, acc[j][0]); epi(r1, c, acc[j][2]); }
        if (c + 1 < N) { epi(r0, c + 1, acc[j][1]); epi(r1, c + 1, acc[j][3]); }
      }
    }
  }
}

#endif

// out[r][c] = sum_k A(r, k) * B[k * ldb + c] for r < TR, c < N, handed to
// epi(r, c, acc). bf16 runs on the tensor cores (block_mm_mma); f32 on
// the CUDA cores, where each thread owns 4x4 micro-tiles. Either way the mapping from (r, c) to thread
// depends only on N, so two calls with the same N give every element to
// the same thread (the skip and dir layers rely on this to combine two
// products without a barrier).
template <typename T, typename AFn, typename Epi>
__device__ __forceinline__ void block_mm(int K, int N, const T* __restrict__ B, int ldb,
                                         AFn A, Epi epi) {
#ifndef NEFES_EMULATE
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    block_mm_mma(K, N, B, ldb, A, epi);
    return;
  }
#endif
  const int ncg = (N + 3) >> 2;
  const int n_mt = (TR / 4) * ncg;
  for (int mt = threadIdx.x; mt < n_mt; mt += blockDim.x) {
    const int r0 = (mt / ncg) * 4, c0 = (mt % ncg) * 4;
    const int nc = N - c0 < 4 ? N - c0 : 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const T* bp = B + c0;
    for (int k = 0; k < K; ++k, bp += ldb) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A(r0 + i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = j < nc ? to_f<T>(bp[j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nc) epi(r0 + i, c0 + j, acc[i][j]);
  }
}

// One bias's gradient from one tile: part[c] = sum_r G(r, c) in f32, in
// row order.
template <typename GFn>
__device__ __forceinline__ void block_db(int N, GFn G, float* __restrict__ part) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 16
    for (int r = 0; r < TR; ++r) s += G(r, c);
    part[c] = s;
  }
}

// Load rows [row0, row0 + TR) of a (rows, C) array into an f32 tile;
// rows at or past `valid` read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t row0,
                                          int valid, int C) {
  for (int i = threadIdx.x; i < TR * C; i += blockDim.x) {
    const int r = i / C;
    dst[i] = r < valid ? to_f<T>(src[(row0 + r) * C + (i - r * C)]) : 0.f;
  }
}

// The raw-input prologue (K5-K8; mirrors _embed_block): the frequency
// embedding of rows [row0, row0 + TR) of x (rows, 3) f32, written straight
// into the tile buffer dst (TR x C, C = 3 + 6 nf) in the reference order
// [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], each value rounded to T.
// The phases x * 2^k are exact f32 scalings (a tensor-core product would
// round x to bf16 first: radians of error at the top band), and sin/cos
// are the full-precision sinf/cosf, whose argument reduction holds at the
// hundreds of radians the top band reaches (the __sinf intrinsic does
// not). Rows at or past `valid` read as zero.
// Column c of the embedding of one point xr (3 f32), unrounded.
__device__ __forceinline__ float embed_value(const float* __restrict__ xr, int c) {
  if (c < 3) return xr[c];
  const int k = (c - 3) / 6, m = (c - 3) - 6 * k;
  const float ph = ldexpf(xr[m % 3], k);
  return m < 3 ? sinf(ph) : cosf(ph);
}

template <typename T>
__device__ __forceinline__ void embed_tile(float* dst, const float* __restrict__ x, size_t row0,
                                           int valid, int C) {
  for (int i = threadIdx.x; i < TR * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    dst[i] = r < valid ? rnd<T>(embed_value(x + (row0 + r) * 3, c)) : 0.f;
  }
}

// The raw-input epilogue (K6, K8; mirrors the d_embed step of
// _mlp_backward): the embedding cotangent de (TR x C f32) of the tile's
// rows back to dx (rows, 3) f32, dx_i = de_i + sum_k 2^k (de_sin(k, i)
// cos(2^k x_i) - de_cos(k, i) sin(2^k x_i)), the phases recomputed from x
// rather than kept.
// Coordinate j of one point's cotangent from its embedding's cotangent d
// (C = 3 + 6 nf f32 values), the point's coordinate xv given.
__device__ __forceinline__ float embed_grad(const float* d, float xv, int j, int C) {
  float acc = d[j];
  for (int k = 0; k < (C - 3) / 6; ++k) {
    const float ph = ldexpf(xv, k);
    acc += ldexpf(d[3 + 6 * k + j] * cosf(ph) - d[6 + 6 * k + j] * sinf(ph), k);
  }
  return acc;
}

__device__ __forceinline__ void embed_backward_tile(const float* de, const float* __restrict__ x,
                                                    float* __restrict__ dx, size_t row0,
                                                    int valid, int C) {
  for (int i = threadIdx.x; i < valid * 3; i += blockDim.x) {
    const int r = i / 3, j = i - 3 * r;
    dx[(row0 + r) * 3 + j] = embed_grad(de + r * C, x[(row0 + r) * 3 + j], j, C);
  }
}

// The tile's inputs into s.emb and s.embd: rows of the pre-embedded (N,
// E) / (N, Ed) arrays in T or, RAW, the embedding of the f32 (N, 3)
// points and directions. Ends with a barrier.
template <typename T, bool RAW>
__device__ __forceinline__ void tile_inputs(const Dims& d, const Smem& s, const void* x,
                                            const void* dirs, size_t row0, int valid) {
  if (RAW) {
    embed_tile<T>(s.emb, static_cast<const float*>(x), row0, valid, d.E);
    embed_tile<T>(s.embd, static_cast<const float*>(dirs), row0, valid, d.Ed);
  } else {
    load_tile<T>(s.emb, static_cast<const T*>(x), row0, valid, d.E);
    load_tile<T>(s.embd, static_cast<const T*>(dirs), row0, valid, d.Ed);
  }
  __syncthreads();
}

// After tower_backward: the cotangents it left in s.demb and s.embd out to
// the tile's valid rows, as (N, E) / (N, Ed) rows in T or, RAW, through
// the embedding as (N, 3) f32 point and direction cotangents (x, dirs are
// the raw inputs then). Ends with a barrier, so the next tile may reuse
// the buffers.
template <typename T, bool RAW>
__device__ __forceinline__ void tile_input_grads(const Dims& d, const Smem& s, const void* x,
                                                 const void* dirs, void* dx, void* ddirs,
                                                 size_t row0, int valid) {
  if (RAW) {
    embed_backward_tile(s.demb, static_cast<const float*>(x), static_cast<float*>(dx), row0,
                        valid, d.E);
    embed_backward_tile(s.embd, static_cast<const float*>(dirs), static_cast<float*>(ddirs),
                        row0, valid, d.Ed);
  } else {
    T* de = static_cast<T*>(dx);
    for (int i = threadIdx.x; i < valid * d.E; i += blockDim.x)
      de[row0 * d.E + i] = from_f<T>(s.demb[i]);
    T* dd = static_cast<T*>(ddirs);
    for (int i = threadIdx.x; i < valid * d.Ed; i += blockDim.x)
      dd[row0 * d.Ed + i] = from_f<T>(s.embd[i]);
  }
  __syncthreads();
}


// Forward tower over the tile in s.emb / s.embd (mirrors _tower_tile) in
// transient mode, as the backward recomputes it. Leaves the last hidden
// layer's sigma pre-activation in s.zs, the ReLU bits of every hidden
// layer in s.mask, the dir-layer output in s.de, the three transient
// layers in s.t1..t3 and the transient heads' pre-activations [sigma, rgb
// x3, beta] in s.tz; with dw.ops (the backward with dW), every layer
// input of a dW product (the embeddings, the hidden layers, `final`, the
// dir layer's output and the transient layers) in its slot of the chunk.
// The rgb/feature head, whose output the backward does not read, is not
// computed. Ends with a barrier.
template <typename T>
__device__ void tower_forward(const Tower<T>& tw, const Smem& s, const DwOut<T>& dw) {
  const Dims& d = tw.d;
  const Layout& L = tw.L;
  const int W = d.width, H = W / 2, E = d.E, Ed = d.Ed, nw = W / 32;
  float* h = s.h0;
  float* hn = s.h1;
  const float* emb = s.emb;
  auto a_emb = [=](int r, int k) { return emb[r * E + k]; };
  if (dw.ops) {
    put_tile(dw, A_EMB, s.emb);
    put_tile(dw, A_EMBD, s.embd);
  }

  for (int i = 0; i < d.depth; ++i) {
    const float* bias = tw.b + L.b[i];
    const float* hc = h;
    float* ho = hn;
    auto a_h = [=](int r, int k) { return hc[r * W + k]; };
    auto bias_relu = [=](int r, int c, float z) {
      z = rnd<T>(z + rnd<T>(bias[c]));
      ho[r * W + c] = fmaxf(z, 0.f);
    };
    if (i == 0) {
      block_mm<T>(E, W, tw.w + L.we[0], W, a_emb,
                  [=](int r, int c, float acc) { bias_relu(r, c, rnd<T>(acc)); });
    } else if ((d.skipmask >> i) & 1) {
      block_mm<T>(W, W, tw.w + L.wh[i], W, a_h,
                  [=](int r, int c, float acc) { ho[r * W + c] = rnd<T>(acc); });
      block_mm<T>(E, W, tw.w + L.we[i], W, a_emb, [=](int r, int c, float acc) {
        bias_relu(r, c, rnd<T>(ho[r * W + c] + rnd<T>(acc)));
      });
    } else {
      block_mm<T>(W, W, tw.w + L.wh[i], W, a_h,
                  [=](int r, int c, float acc) { bias_relu(r, c, rnd<T>(acc)); });
    }
    __syncthreads();
    {
      uint32_t* m = s.mask + (size_t)i * TR * nw;
      for (int j = threadIdx.x; j < TR * nw; j += blockDim.x) {
        const float* row = ho + (j / nw) * W + (j % nw) * 32;
        uint32_t bits = 0;
        for (int t = 0; t < 32; ++t) bits |= (row[t] > 0.f ? 1u : 0u) << t;
        m[j] = bits;
      }
    }
    if (dw.ops) put_tile(dw, A_H + i, ho);
    h = ho;
    hn = const_cast<float*>(hc);
  }

  // sigma head: f32 accumulation plus f32 bias
  {
    const float* hc = h;
    const float sb = tw.b[L.sig_b];
    float* zs = s.zs;
    block_mm<T>(W, 1, tw.w + L.sig_w, 1, [=](int r, int k) { return hc[r * W + k]; },
                [=](int r, int c, float acc) { zs[r] = acc + sb; });
  }
  // final = h @ fin_w + fin_b (no activation), into the free buffer hn
  {
    const float* hc = h;
    float* fin = hn;
    const float* fb = tw.b + L.fin_b;
    block_mm<T>(W, W, tw.w + L.fin_w, W, [=](int r, int k) { return hc[r * W + k]; },
                [=](int r, int c, float acc) {
                  fin[r * W + c] = rnd<T>(rnd<T>(acc) + rnd<T>(fb[c]));
                });
  }
  __syncthreads();
  if (dw.ops) put_tile(dw, A_H + d.depth, hn);

  // de = relu(final @ dir_wh + embd @ dir_wd + dir_b)
  const float* fin = hn;
  const float* embd = s.embd;
  auto a_fin = [=](int r, int k) { return fin[r * W + k]; };
  auto a_embd = [=](int r, int k) { return embd[r * Ed + k]; };
  {
    float* de = s.de;
    const float* db = tw.b + L.dir_b;
    block_mm<T>(W, H, tw.w + L.dir_wh, H, a_fin,
                [=](int r, int c, float acc) { de[r * H + c] = rnd<T>(acc); });
    block_mm<T>(Ed, H, tw.w + L.dir_wd, H, a_embd, [=](int r, int c, float acc) {
      float z = rnd<T>(de[r * H + c] + rnd<T>(acc));
      z = rnd<T>(z + rnd<T>(db[c]));
      de[r * H + c] = fmaxf(z, 0.f);
    });
  }
  __syncthreads();
  if (dw.ops) put_tile(dw, A_DE, s.de);

  // t1 = relu(final @ t1_wh + embd @ t1_wd + t1_b), then two 64-wide
  // layers, each rounded like the dir layer
  float* t1 = s.t1;
  const float* b1 = tw.b + L.t1_b;
  block_mm<T>(W, H, tw.w + L.t1_wh, H, a_fin,
              [=](int r, int c, float acc) { t1[r * H + c] = rnd<T>(acc); });
  block_mm<T>(Ed, H, tw.w + L.t1_wd, H, a_embd, [=](int r, int c, float acc) {
    float z = rnd<T>(t1[r * H + c] + rnd<T>(acc));
    z = rnd<T>(z + rnd<T>(b1[c]));
    t1[r * H + c] = fmaxf(z, 0.f);
  });
  __syncthreads();
  if (dw.ops) put_tile(dw, A_T1, s.t1);
  const float* src[2] = {s.t1, s.t2};
  float* dst[2] = {s.t2, s.t3};
  const int wo[2] = {L.t2_w, L.t3_w}, bo[2] = {L.t2_b, L.t3_b};
  for (int l = 0; l < 2; ++l) {
    const float* a = src[l];
    float* o = dst[l];
    const float* bb = tw.b + bo[l];
    block_mm<T>(H, H, tw.w + wo[l], H, [=](int r, int k) { return a[r * H + k]; },
                [=](int r, int c, float acc) {
                  o[r * H + c] = fmaxf(rnd<T>(rnd<T>(acc) + rnd<T>(bb[c])), 0.f);
                });
    __syncthreads();
    if (dw.ops) put_tile(dw, A_T2 + l, o);
  }
  // heads: f32 accumulation plus f32 bias, columns [sigma, rgb x3, beta]
  const float* t3 = s.t3;
  float* tz = s.tz;
  const float bs = tw.b[L.ts_b], bb = tw.b[L.tb_b];
  const float* br = tw.b + L.tr_b;
  auto a_t3 = [=](int r, int k) { return t3[r * H + k]; };
  block_mm<T>(H, 1, tw.w + L.ts_w, 1, a_t3,
              [=](int r, int, float acc) { tz[r * 5] = acc + bs; });
  block_mm<T>(H, 3, tw.w + L.tr_w, 3, a_t3,
              [=](int r, int c, float acc) { tz[r * 5 + 1 + c] = acc + br[c]; });
  block_mm<T>(H, 1, tw.w + L.tb_w, 1, a_t3,
              [=](int r, int, float acc) { tz[r * 5 + 4] = acc + bb; });
  __syncthreads();
}

// The transient heads from their pre-activations: softplus, sigmoid x3,
// softplus.
__device__ __forceinline__ float transient_head(float z, int j) {
  return (j == 0 || j == 4) ? softplus(z) : sigmoid(z);
}

// Backward of the tower in transient mode (mirrors _mlp_backward up to
// the embedding). Needs the state tower_forward left with keep_masks.
// gsig(r): cotangent of the sigma output; grf(r, c), c < 3 + F: of the
// rgb/feature head; gtr(r, j), j < 5: of the transient heads. Leaves the
// embedding cotangents in f32 in s.demb and s.embd (the dir embedding is
// not needed again). With
// dw.ops (whose A operands tower_forward wrote) writes every dW product's
// G operand, a layer's output cotangent rounded to T, to its slot of the
// chunk, and the heads' bias gradients over the tile (sigma, rgb/feature
// and the transient heads: the f32 sums of their unrounded cotangents) to
// dw.part_b; the other biases' gradients, sums of the rounded G, are the
// dW kernel's. Ends with a barrier.
template <typename T, typename GSig, typename GRf, typename GTr>
__device__ void tower_backward(const Tower<T>& tw, const Smem& s, GSig gsig, GRf grf, GTr gtr,
                               const DwOut<T>& dw) {
  const Dims& d = tw.d;
  const Layout& L = tw.L;
  const int W = d.width, H = W / 2, E = d.E, C = 3 + d.F, nw = W / 32;
  const T* sig_w = tw.w + L.sig_w;
  const bool wgrad = dw.ops != nullptr;
  float* pb = dw.part_b;
  // G operand slot k of the tile's rows (values rounded to T on the store)
  auto put_g = [=](int k, auto g) { put_rows(dw, k, g); };

  // dzs stays unrounded: the sigma bias gradient sums it in f32
  for (int r = threadIdx.x; r < TR; r += blockDim.x)
    s.dzs[r] = gsig(r) * sigmoid(s.zs[r]);   // softplus' = sigmoid
  for (int i = threadIdx.x; i < TR * E; i += blockDim.x) s.demb[i] = 0.f;
  __syncthreads();

  float* dh = s.h0;
  float* dn = s.h1;
  const float* dzs = s.dzs;
  auto g_sig = [=](int r, int) { return dzs[r]; };
  if (wgrad) {
    put_g(G_SIG, g_sig);
    block_db(1, g_sig, pb + L.sig_b);
  }
  float* dzd = s.de;   // overwritten in place: each element by its own thread
  if (wgrad) {
    put_g(G_RGB, grf);
    block_db(C, grf, pb + L.rgb_b);
  }
  block_mm<T>(C, H, tw.wt + L.rgb_w, H, [=](int r, int k) { return rnd<T>(grf(r, k)); },
              [=](int r, int c, float acc) {
                dzd[r * H + c] = dzd[r * H + c] > 0.f ? rnd<T>(acc) : 0.f;
              });
  // head cotangents through softplus / sigmoid, in place, f32
  float* tz = s.tz;
  for (int i = threadIdx.x; i < TR * 5; i += blockDim.x) {
    const int j = i % 5;
    const float sg = sigmoid(tz[i]);
    const float g = gtr(i / 5, j);
    tz[i] = (j == 0 || j == 4) ? g * sg : g * sg * (1.f - sg);
  }
  __syncthreads();

  float* t1 = s.t1;
  float* t2 = s.t2;
  float* t3 = s.t3;
  const float* dz5 = s.tz;
  if (wgrad) {
    auto g_ts = [=](int r, int) { return dz5[r * 5]; };
    auto g_tr = [=](int r, int c) { return dz5[r * 5 + 1 + c]; };
    auto g_tb = [=](int r, int) { return dz5[r * 5 + 4]; };
    put_g(G_TS, g_ts);
    put_g(G_TR, g_tr);
    put_g(G_TB, g_tb);
    block_db(1, g_ts, pb + L.ts_b);
    block_db(3, g_tr, pb + L.tr_b);
    block_db(1, g_tb, pb + L.tb_b);
  }
  // dt3: the three heads' products, each rounded to T, summed in T in
  // the order sigma + rgb + beta; times relu'(t3), in place
  {
    const T* tsw = tw.w + L.ts_w;
    const T* trw = tw.w + L.tr_w;
    const T* tbw = tw.w + L.tb_w;
    for (int i = threadIdx.x; i < TR * H; i += blockDim.x) {
      const int r = i / H, c = i - r * H;
      const float* g = dz5 + r * 5;
      const float a = rnd<T>(rnd<T>(g[0]) * to_f<T>(tsw[c]));
      float acc = 0.f;
      for (int j = 0; j < 3; ++j) acc = fmaf(rnd<T>(g[1 + j]), to_f<T>(trw[c * 3 + j]), acc);
      const float b = rnd<T>(acc);
      const float e = rnd<T>(rnd<T>(g[4]) * to_f<T>(tbw[c]));
      const float v = rnd<T>(rnd<T>(a + b) + e);
      t3[i] = t3[i] > 0.f ? v : 0.f;
    }
  }
  __syncthreads();
  // t3 -> t2 -> t1, each: the output cotangent out as G, then the
  // input's cotangent in place of the input
  float* tin[2] = {t2, t1};
  const float* tout[2] = {t3, t2};
  const int wo[2] = {L.t3_w, L.t2_w};
  for (int l = 0; l < 2; ++l) {
    float* a = tin[l];
    const float* g = tout[l];
    auto g_t = [=](int r, int c) { return g[r * H + c]; };
    if (wgrad) put_g(G_T3 - l, g_t);
    block_mm<T>(H, H, tw.wt + wo[l], H, g_t, [=](int r, int c, float acc) {
      a[r * H + c] = a[r * H + c] > 0.f ? rnd<T>(acc) : 0.f;
    });
    __syncthreads();
  }

  const float* dzt1 = s.t1;
  auto g_d = [=](int r, int c) { return dzd[r * H + c]; };
  auto g_t1 = [=](int r, int c) { return dzt1[r * H + c]; };
  if (wgrad) {
    put_g(G_DIR, g_d);
    put_g(G_T1, g_t1);
  }
  // d_final = dzd @ dir_wh^T (+ dzt1 @ t1_wh^T), each rounded, into dn;
  // d_embd = dzd @ dir_wd^T (+ dzt1 @ t1_wd^T) in f32, into s.embd. The
  // second product of each pair has the first one's N, so every element
  // goes to the same thread and no barrier sits between them.
  block_mm<T>(H, W, tw.wt + L.dir_wh, W, g_d,
              [=](int r, int c, float acc) { dn[r * W + c] = rnd<T>(acc); });
  float* dembd = s.embd;
  block_mm<T>(H, d.Ed, tw.wt + L.dir_wd, d.Ed, g_d,
              [=](int r, int c, float acc) { dembd[r * d.Ed + c] = acc; });
  block_mm<T>(H, W, tw.wt + L.t1_wh, W, g_t1, [=](int r, int c, float acc) {
    dn[r * W + c] = rnd<T>(dn[r * W + c] + rnd<T>(acc));
  });
  block_mm<T>(H, d.Ed, tw.wt + L.t1_wd, d.Ed, g_t1,
              [=](int r, int c, float acc) { dembd[r * d.Ed + c] += acc; });
  __syncthreads();
  const float* dfin = dn;
  auto g_fin = [=](int r, int c) { return dfin[r * W + c]; };
  if (wgrad) put_g(G_FIN, g_fin);
  block_mm<T>(W, W, tw.wt + L.fin_w, W, g_fin, [=](int r, int c, float acc) {
    dh[r * W + c] = rnd<T>(rnd<T>(rnd<T>(dzs[r]) * to_f<T>(sig_w[c])) + rnd<T>(acc));
  });
  __syncthreads();

  float* demb = s.demb;
  for (int i = d.depth - 1; i >= 0; --i) {
    const uint32_t* m = s.mask + (size_t)i * TR * nw;
    const float* g = dh;
    auto dz = [=](int r, int k) {
      return (m[r * nw + (k >> 5)] >> (k & 31)) & 1u ? g[r * W + k] : 0.f;
    };
    if (wgrad) put_g(G_DZ + i, dz);
    auto add_emb = [=](int r, int c, float acc) { demb[r * E + c] += acc; };
    if (i == 0) {
      block_mm<T>(W, E, tw.wt + L.we[0], E, dz, add_emb);
    } else {
      float* o = dn;
      block_mm<T>(W, W, tw.wt + L.wh[i], W, dz,
                  [=](int r, int c, float acc) { o[r * W + c] = rnd<T>(acc); });
      if ((d.skipmask >> i) & 1) block_mm<T>(W, E, tw.wt + L.we[i], E, dz, add_emb);
      __syncthreads();
      dn = dh;
      dh = o;
    }
  }
  __syncthreads();
}

}  // namespace nefes
