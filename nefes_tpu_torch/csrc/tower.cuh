// Shared device code of the NeRFH-NFF tower kernels: the dims, layout,
// rounding helpers and embedding every kernel reads, the dW operands' slot
// layout that the field backward writes and field_dw.cuh reads, and
// micro.cu's block product (block_mm). The tower itself, forward and
// backward, runs on render_bwd.cuh's warp path in every kernel: the field
// forward K1/K5 and backward K2/K6 in every mode and the render kernels
// K3/K4/K7/K8.
//
// Mirrors the Pallas kernels of nefes_tpu/kernels/fused_field.py
// (_embed_block, _tower_tile, _mlp_backward, pre=True or False,
// need_dw=True or False): hidden layers accumulate in f32 and round to the
// pack dtype T, then take the bias and the ReLU in T; heads accumulate in
// f32; a weight gradient is act^T · g with act in T and g rounded to T,
// accumulated in f32, a bias gradient the f32 sum of g (_mlp_backward's
// dmat).
//
// Weight gradients across tiles: the TPU grid runs in order and carries
// dW in VMEM from one tile to the next. A GPU grid does not, so the
// backward with dW (need_dw) runs over chunks of rows: each warp writes
// its rows' dW operands to the chunk's row-major buffers in global memory
// (every layer input, A, in T, and every layer output cotangent, G,
// rounded to T; the slots below, by streaming stores) and the head
// biases' gradients (f32 sums of their unrounded cotangents) go to one
// row of a per-tile f32 buffer a TR-row tile. field_dw.cuh's kernel then
// contracts each product A^T G over the chunk's rows, the other biases as
// column sums of G. No atomics and fixed orders throughout, so the
// gradient and a training run's loss curve are the same from run to run.
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
constexpr int TR = 64;        // rows of a head bias sum tile (dW), of a micro.cu sub-tile
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

// Next 16-byte aligned buffer of n 4-byte words at base + *off.
__host__ __device__ inline float* take(char* base, size_t* off, size_t n) {
  float* p = base ? reinterpret_cast<float*>(base + *off) : nullptr;
  *off += ((n * 4 + 15) / 16) * 16;
  return p;
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

// Eight values to p[0..8) in T (p holds an element index of a row that is
// a multiple of 8), by streaming stores (st.global.cs: evict first). The
// operands pass through L2 once on their way out; stored as usual, they
// evicted the weights that the first design's tiles read from L2, which
// cost its K6 +dW 8.5 ms of 59 at the fine training pass on an H100
// (PERF.md §6).
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

#ifndef NEFES_EMULATE
// Tensor-core product for bf16 (micro.cu's chains; pack_bf16x2 and
// mma_bf16 are also the warp path's): mma.sync m16n8k16 (bf16 in, f32
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
// the CUDA cores, where each thread owns 4x4 micro-tiles.
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

// The raw-input prologue (K5-K8; mirrors _embed_block): column c of the
// frequency embedding of one point xr (3 f32), unrounded, in the
// reference order [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]. The phases
// x * 2^k are exact f32 scalings (a tensor-core product would round x to
// bf16 first: radians of error at the top band), and sin/cos are the
// full-precision sinf/cosf, whose argument reduction holds at the hundreds
// of radians the top band reaches (the __sinf intrinsic does not).
__device__ __forceinline__ float embed_value(const float* __restrict__ xr, int c) {
  if (c < 3) return xr[c];
  const int k = (c - 3) / 6, m = (c - 3) - 6 * k;
  const float ph = ldexpf(xr[m % 3], k);
  return m < 3 ? sinf(ph) : cosf(ph);
}

// The raw-input epilogue (K6, K8; mirrors the d_embed step of
// _mlp_backward): coordinate j of one point's cotangent from its
// embedding's cotangent d (C = 3 + 6 nf f32 values), the point's
// coordinate xv given: d_j + sum_k 2^k (d_sin(k, j) cos(2^k xv) -
// d_cos(k, j) sin(2^k xv)), the phases recomputed from the point rather
// than kept.
__device__ __forceinline__ float embed_grad(const float* d, float xv, int j, int C) {
  float acc = d[j];
  for (int k = 0; k < (C - 3) / 6; ++k) {
    const float ph = ldexpf(xv, k);
    acc += ldexpf(d[3 + 6 * k + j] * cosf(ph) - d[6 + 6 * k + j] * sinf(ph), k);
  }
  return acc;
}

// The transient heads from their pre-activations: softplus, sigmoid x3,
// softplus.
__device__ __forceinline__ float transient_head(float z, int j) {
  return (j == 0 || j == 4) ? softplus(z) : sigmoid(z);
}

}  // namespace nefes
