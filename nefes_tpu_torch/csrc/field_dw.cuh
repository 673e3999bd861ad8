// The weight gradients of the field backward with dW (K2/K6, need_dw): a
// kernel of their own that contracts each product dW[K x N] += A^T G over
// the rows of a chunk, from the operands the backward wrote (tower.cuh's
// slots: A a layer's input in T, G its output cotangent rounded to T).
//
// Replaces the weight-gradient half of _mlp_backward's dmat
// (nefes_tpu/kernels/fused_field.py:477-486: dW += act^T g, db += sum g, in
// VMEM across the TPU's sequential grid). A GPU block cannot carry sums
// from one tile to the next, and adding each 64-row tile's products into
// an f32 partial of every weight (668 KB at D8/W128/F128) costs a
// read-modify-write of the partial per 4 k-steps; here a product
// contracts thousands of rows before its sums leave the registers.
//
// Grid: `slices` row slices x `jobs` jobs a slice. A slice is a fixed
// range of the chunk's tiles (so of its rows). A job is one 64 x 64 output
// tile of one product of dw_prod's list: a weight's A^T G, or a bias's
// gradient as a row of ones times G (the f32 column sums of the rounded g,
// the sums _mlp_backward takes); or one range of NT head biases (sigma,
// rgb/feature, transient heads, whose cotangents are not rounded), whose
// per-tile f32 sums the backward left in tile_b. A job adds its sums, over
// the slice's rows in row order or its tiles in tile order, into the
// slice's f32 partial part[s] (nw matrix entries, then nb biases, at their
// blob offsets). Every element of part[s] is written by one thread once a
// chunk; chunks run in order on the stream and the slices are summed in
// slice order (dw_reduce_kernel), so the result does not depend on the
// launch: no atomics.
//
// bf16 (the card): 8 warps, each owning a 16 x 32 block of the output tile
// (4 m16n8k16 accumulators); 64-row stages of A's and G's 64 columns are
// copied by cp.async, double-buffered, into rows of 72 elements (an odd
// number of 16-byte units, so ldmatrix.trans reads them without bank
// conflicts) and fed to mma.sync by ldmatrix.x4.trans (the rows are the
// contraction, so both A and G are read transposed). Columns past a
// product's K or N and rows past the slice read zeros or land in outputs
// that are not stored. Bound (D8/W128/F128, transient, bf16): about 0.37
// MFLOP a row on the tensor cores against about 6 KB of operands a row,
// so the bytes (0.29 ms a chunk of 157,312 rows at 3.35 TB/s); a product
// job reads its A columns once an n-tile of G, and 0.74-0.80 ms a chunk was
// measured on an H100 (PERF.md). f32 runs the same jobs on the CUDA cores,
// each thread a 4 x 4 micro-tile with FMA (the parity path; the host build
// checks it on the CPU).

#pragma once

#include "render_bwd.cuh"

namespace nefes {

constexpr int DW_T = 64;            // output tile of a product job, rows and columns
constexpr int DW_BK = 64;           // rows of one stage
constexpr int DW_LD = DW_T + 8;     // stage row stride, elements

// One dW product: A slot, G slot, dW's K x N, its offset in the matrix blob;
// or, a = A_ONES, a bias's gradient as the product of a row of ones with
// G (K = 1), at offset w of the bias blob.
struct DwProd {
  int a, g, K, N, w;
};
constexpr int A_ONES = -2;

// The k-th dW product of `mode` (a = -1 past the last): the hidden layers
// in order (each with its skip input), the sigma head, then (FULL and
// TRANSIENT) final, the dir layer's two and the rgb/feature head, then
// (TRANSIENT) the first transient layer's two, t2, t3 and the three heads.
__host__ __device__ inline DwProd dw_prod(const Dims& d, const Layout& L, int mode, int k) {
  const int W = d.width, H = W / 2, C = 3 + d.F, D = d.depth;
  int n = 0;
  for (int i = 0; i < D; ++i) {
    if (i == 0) {
      if (k == n++) return {A_EMB, G_DZ, d.E, W, L.we[0]};
    } else {
      if (k == n++) return {A_H + i - 1, G_DZ + i, W, W, L.wh[i]};
      if (((d.skipmask >> i) & 1) && k == n++) return {A_EMB, G_DZ + i, d.E, W, L.we[i]};
    }
  }
  if (k == n++) return {A_H + D - 1, G_SIG, W, 1, L.sig_w};
  if (mode != SIGMA) {
    if (k == n++) return {A_H + D - 1, G_FIN, W, W, L.fin_w};
    if (k == n++) return {A_H + D, G_DIR, W, H, L.dir_wh};
    if (k == n++) return {A_EMBD, G_DIR, d.Ed, H, L.dir_wd};
    if (k == n++) return {A_DE, G_RGB, H, C, L.rgb_w};
  }
  if (mode == TRANSIENT) {
    if (k == n++) return {A_H + D, G_T1, W, H, L.t1_wh};
    if (k == n++) return {A_EMBD, G_T1, d.Ed, H, L.t1_wd};
    if (k == n++) return {A_T1, G_T2, H, H, L.t2_w};
    if (k == n++) return {A_T2, G_T3, H, H, L.t3_w};
    if (k == n++) return {A_T3, G_TS, H, 1, L.ts_w};
    if (k == n++) return {A_T3, G_TR, H, 3, L.tr_w};
    if (k == n++) return {A_T3, G_TB, H, 1, L.tb_w};
  }
  for (int i = 0; i < D; ++i)
    if (k == n++) return {A_ONES, G_DZ + i, 1, W, L.b[i]};
  if (mode != SIGMA) {
    if (k == n++) return {A_ONES, G_FIN, 1, W, L.fin_b};
    if (k == n++) return {A_ONES, G_DIR, 1, H, L.dir_b};
  }
  if (mode == TRANSIENT) {
    if (k == n++) return {A_ONES, G_T1, 1, H, L.t1_b};
    if (k == n++) return {A_ONES, G_T2, 1, H, L.t2_b};
    if (k == n++) return {A_ONES, G_T3, 1, H, L.t3_b};
  }
  return {-1, -1, 0, 0, 0};
}

// The k-th range of head biases whose per-tile sums the backward leaves
// (unrounded cotangents): {offset in the bias blob, length}; length 0
// past the last.
struct DwRange {
  int off, len;
};

__host__ __device__ inline DwRange dw_head(const Dims& d, const Layout& L, int mode, int k) {
  int n = 0;
  if (k == n++) return {L.sig_b, 1};
  if (mode != SIGMA && k == n++) return {L.rgb_b, 3 + d.F};
  if (mode == TRANSIENT && k == n++) return {L.ts_b, 5};   // ts_b, tr_b, tb_b
  return {0, 0};
}

__host__ __device__ inline int dw_tiles(const DwProd& p) {
  return ((p.K + DW_T - 1) / DW_T) * ((p.N + DW_T - 1) / DW_T);
}

// Jobs of one slice: every product's output tiles, then the head bias
// ranges, NT biases a job.
__host__ __device__ inline int dw_jobs(const Dims& d, int mode) {
  const Layout L = make_layout(d);
  int jobs = 0;
  for (int k = 0; dw_prod(d, L, mode, k).a != -1; ++k) jobs += dw_tiles(dw_prod(d, L, mode, k));
  for (int k = 0; dw_head(d, L, mode, k).len > 0; ++k)
    jobs += (dw_head(d, L, mode, k).len + NT - 1) / NT;
  return jobs;
}

#ifndef NEFES_EMULATE
// out[m * N + n] += sum over rows [r0, r1) of A[r][m0 + m] G[r][n0 + n] for
// the 64 x 64 tile at (m0, n0), m0 + m < K, n0 + n < N, on the tensor cores;
// A == nullptr reads ones (a bias: every row of the tile holds G's column
// sums, row 0 is stored).
__device__ __forceinline__ void dw_tile_mma(const __nv_bfloat16* __restrict__ A, int lda,
                                            const __nv_bfloat16* __restrict__ G, int ldg, int K,
                                            int N, int m0, int n0, int r0, int r1,
                                            float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][DW_BK * DW_LD];
  __shared__ __align__(16) __nv_bfloat16 sg[2][DW_BK * DW_LD];
  constexpr int UNITS = DW_BK * (DW_T / 8);   // 16-byte copies of one side's stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ms = (warp & 3) * 16, ns = (warp >> 2) * 32;
  // rows [rb, rb + DW_BK) of A's (unless ones) and G's 64 columns into
  // stage `buf`: zeros past the slice's rows and the buffers' columns
  auto load = [&](int buf, int rb) {
    for (int u = threadIdx.x + (A ? 0 : UNITS); u < 2 * UNITS; u += blockDim.x) {
      const bool gside = u >= UNITS;
      const int v = gside ? u - UNITS : u;
      const int rr = v / (DW_T / 8), cu = (v % (DW_T / 8)) * 8;
      const int ld = gside ? ldg : lda, c = (gside ? n0 : m0) + cu, r = rb + rr;
      __nv_bfloat16* dst = (gside ? sg[buf] : sa[buf]) + rr * DW_LD + cu;
      if (r < r1 && c < ld)
        cp_async16(dst, (gside ? G : A) + (size_t)r * ld + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (r0 < r1) load(0, r0);
  int buf = 0;
  for (int rb = r0; rb < r1; rb += DW_BK, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // stage buf is in; every warp is done with the other
    if (rb + DW_BK < r1) load(buf ^ 1, rb + DW_BK);
    const __nv_bfloat16* as = sa[buf];
    const __nv_bfloat16* gs = sg[buf];
#pragma unroll
    for (int k0 = 0; k0 < DW_BK; k0 += 16) {
      // A^T's fragment: the 8 x 8 matrices (rows k0 / k0 + 8, columns ms /
      // ms + 8) in the order a[0..3] takes them; bf16 ones for a bias
      uint32_t a[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
      if (A)
        ldsm_x4_t(a, as + (k0 + (lane & 7) + ((lane >> 4) << 3)) * DW_LD + ms +
                         (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, gs + (k0 + (lane & 15)) * DW_LD + ns + 16 * j + ((lane >> 4) << 3));
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + ms + g, n = n0 + ns + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m + 8 * h;
      if (mm >= K) continue;
      if (n < N) out[(size_t)mm * N + n] += acc[j][2 * h];
      if (n + 1 < N) out[(size_t)mm * N + n + 1] += acc[j][2 * h + 1];
    }
  }
}
#endif

// The same on the CUDA cores: each thread a 4 x 4 micro-tile, FMA in row
// order.
template <typename T>
__device__ __forceinline__ void dw_tile_fma(const T* __restrict__ A, int lda,
                                            const T* __restrict__ G, int ldg, int K, int N,
                                            int m0, int n0, int r0, int r1,
                                            float* __restrict__ out) {
  for (int u = threadIdx.x; u < (DW_T / 4) * (DW_T / 4); u += blockDim.x) {
    const int mi = m0 + (u / (DW_T / 4)) * 4, ni = n0 + (u % (DW_T / 4)) * 4;
    if (mi >= K || ni >= N) continue;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = r0; r < r1; ++r) {
      float a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = mi + i >= K ? 0.f : A ? to_f<T>(A[(size_t)r * lda + mi + i]) : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = ni + j < N ? to_f<T>(G[(size_t)r * ldg + ni + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (mi + i < K && ni + j < N) out[(size_t)(mi + i) * N + ni + j] += acc[i][j];
  }
}

// One chunk of `rows` rows: ops its operand buffer (tower.cuh's slots),
// tile_b its tiles' head bias sums (tiles x nb f32), part the slices'
// partials (slices x (nw + nb) f32), added to. Block b is job b % jobs of
// slice b / jobs.
template <typename T>
__global__ void __launch_bounds__(NT)
field_dw_kernel(Dims d, int mode, int rows, int jobs, int slices, const T* __restrict__ ops,
                const float* __restrict__ tile_b, int nw, int nb, float* __restrict__ part) {
  const int s = blockIdx.x / jobs;
  int j = blockIdx.x - s * jobs;
  const int tiles = (rows + TR - 1) / TR, per = (tiles + slices - 1) / slices;
  const int t0 = s * per, t1 = t0 + per < tiles ? t0 + per : tiles;
  float* out = part + (size_t)s * (nw + nb);
  const Layout L = make_layout(d);
  DwProd p;
  for (int k = 0;; ++k) {
    p = dw_prod(d, L, mode, k);
    if (p.a == -1 || j < dw_tiles(p)) break;
    j -= dw_tiles(p);
  }
  if (p.a == -1) {   // head biases: the slice's tile sums, in tile order
    DwRange h;
    for (int k = 0;; ++k) {
      h = dw_head(d, L, mode, k);
      const int n = (h.len + NT - 1) / NT;
      if (h.len == 0 || j < n) break;
      j -= n;
    }
    const int c0 = h.off + j * NT, c1 = c0 + NT < h.off + h.len ? c0 + NT : h.off + h.len;
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      float acc = 0.f;
      for (int t = t0; t < t1; ++t) acc += tile_b[(size_t)t * nb + c];
      out[nw + c] += acc;
    }
    return;
  }
  const int n_t = (p.N + DW_T - 1) / DW_T;   // the n-tiles of one m-tile are neighbours
  const int m0 = (j / n_t) * DW_T, n0 = (j % n_t) * DW_T;
  const int r0 = t0 * TR, r1 = t1 * TR < rows ? t1 * TR : rows;
  const T* A = p.a == A_ONES ? nullptr : ops + slot_off(d, mode, rows, p.a);
  const T* G = ops + slot_off(d, mode, rows, p.g);
  const int lda = p.a == A_ONES ? 0 : slot_ld(d, mode, p.a), ldg = slot_ld(d, mode, p.g);
  float* o = out + (p.a == A_ONES ? nw : 0) + p.w;
#ifndef NEFES_EMULATE
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    dw_tile_mma(A, lda, G, ldg, p.K, p.N, m0, n0, r0, r1, o);
    return;
  }
#endif
  dw_tile_fma<T>(A, lda, G, ldg, p.K, p.N, m0, n0, r0, r1, o);
}

}  // namespace nefes
