// Fused NeRFH-NFF field on Hopper: the tower and its heads (forward) and
// the recompute backward, with or without the weight gradients, on
// pre-embedded rows (K1, K2) or on raw points and directions that each
// tile embeds itself (K5, K6); modes sigma, full and transient.
//
// K1 replaces _run_fwd_pre / _fwd_kernel_pre (nefes_tpu/kernels/
// fused_field.py:686-709, 402-416); K2 replaces _run_bwd_pre /
// _bwd_kernel_pre (fused_field.py:712-741, 419-459), need_dw False or
// True. K5 replaces _run_fwd / _fwd_kernel (fused_field.py:597-619,
// 332-338): the embedding in the kernel in place of K1's row load, heads
// written in f32. K6 replaces _run_bwd / _bwd_kernel
// (fused_field.py:622-648, 341-367): K2 with f32 head cotangents and an
// epilogue (embed_backward_tile) that takes the embedding cotangents,
// still in shared memory, to d_pts / d_dirs, recomputing the phases
// instead of storing them. With need_dw the backward also gives one f32
// gradient per packed weight (the TPU kernel's VMEM accumulators,
// fused_field.py:354-358, 440-444, 634-637, 728-731): K2/K6 add each
// tile's into the f32 partial slice of their block (tower.cuh), and
// field_dw_reduce sums the slices in order.
//
// Bound on an H100: operations, not bytes. The forward takes 0.262 MFLOP
// a sample in sigma mode and 0.331 in full mode at D8/W128/F128 (0.37 in
// transient mode); the frozen backward about twice that, with dW three
// times; the embedding adds about 1 kFLOP and 66 sin/cos a sample. The
// bytes are at most ~0.7 KB a sample, plus, with dW, the partial slices
// (about 0.75 MB read and written per tile).
//
// K1/K5 in sigma and full mode (field_warp_kernel) run render_bwd.cuh's
// warp path, the render kernels' tower: a persistent grid of `blocks`
// blocks (one an SM: the block's shared memory holds two weight stages
// and eight warp tiles), each walking block tiles blockIdx.x, blockIdx.x
// + gridDim.x, ... of BT = 128 samples; warp w owns the tile's rows [16 w,
// 16 w + 16) through every layer (warp_forward, cut after the sigma head
// in sigma mode, where dirs is not read), in bf16 rows that ldmatrix
// feeds to mma.sync, the weights staged matrix by matrix by cp.async in
// the sequence of the mode (SEQ_SIGMA: the hidden layers; SEQ_HEADS: those,
// final, the dir layer and the rgb/feature head, read from wt as (N, K)),
// the next tile's first matrix copied during this tile's last product.
// f32 runs the same kernel on the CUDA cores (the host build checks it).
// Transient mode, and the forward that K2/K6 recompute, stay on tower.cuh's
// first design: TR = 64 samples a block, f32 activation tiles, weights
// through L1 (the design notes are in tower.cuh); the frozen backward has
// one block per tile, the backward with dW a persistent grid of `slices`
// blocks.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "render_bwd.cuh"

namespace nefes {

// the type of the heads and their cotangents: the pack dtype T on the
// pre-embedded kernels, f32 on the raw-input ones (as the TPU kernels)
template <typename T, bool RAW>
using Head = typename std::conditional<RAW, float, T>::type;

// Carve one block of field_warp_kernel in forward sequence FWD from base
// (nullptr: size only): two weight stages of the sequence's largest
// matrix (a 2-byte pack dtype stages its weights), eight lean warp
// regions (the embedding rows, the dir embedding rows in full mode, two
// hidden-layer buffers; the dir layer's output overwrites one) and the
// tile's sigma pre-activations; returns the bytes used.
template <Seq FWD>
__host__ __device__ inline size_t carve_field(const Dims& d, const Layout& L, int ts, char* base,
                                              RayBufs* rb) {
  RayBufs t{};
  size_t off = 0;
  auto bytes = [&](size_t n) {
    char* p = base ? base + off : nullptr;
    off += (n + 15) / 16 * 16;
    return p;
  };
  size_t stage = 0;
  const int mats = ts == 2 ? fwd_count<FWD>(d, L) : 0;
  for (int k = 0; k < mats; ++k) {
    const size_t e = staged_elems(fwd_mat<FWD>(d, L, k));
    stage = stage > e ? stage : e;
  }
  t.wbuf[0] = bytes(stage * ts);
  t.wbuf[1] = bytes(stage * ts);
  t.wbytes = warp_layout(d, ts, true, FWD == SEQ_HEADS).total;
  t.warps = bytes(WARPS * t.wbytes);
  t.tzs = take(base, &off, BT);
  if (rb) *rb = t;
  return off;
}

// K1 (pre-embedded x, dirs in T, heads in T) and K5 (RAW: f32 points and
// directions, heads in f32) in sigma mode (HEADS false: sigma (N,) only;
// dirs not read) and full mode (HEADS: also rgb (N, 3) and feat (N, F)):
// sigma = softplus(zs), zs the sigma head's f32 sum plus its f32 bias,
// and the rgb/feature head accumulated in f32 plus its f32 bias, written
// in the head type (as field_fwd_kernel).
template <typename T, bool RAW, bool HEADS>
__global__ void __launch_bounds__(NT, 1)
field_warp_kernel(Tower<T> tw, int n, const void* __restrict__ x, const void* __restrict__ dirs,
                  Head<T, RAW>* __restrict__ sigma, Head<T, RAW>* __restrict__ rgb,
                  Head<T, RAW>* __restrict__ feat) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  constexpr Seq FWD = HEADS ? SEQ_HEADS : SEQ_SIGMA;
  RayBufs rb;
  carve_field<FWD>(tw.d, tw.L, sizeof(T), nefes_smem, &rb);
  const int H = tw.d.width / 2, F = tw.d.F, ldh = ld_of(H);
  const int tiles = (n + BT - 1) / BT, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, mine = b < tiles ? (tiles - 1 - b) / (int)gridDim.x + 1 : 0;
  Stager<T, FWD> st(tw, rb, mine, false);   // the block's tiles b, b + gridDim.x, ...
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP) {
      const int s0 = t * BT + wp * WR;
      const int vr = n - s0 < 0 ? 0 : (n - s0 < WR ? n - s0 : WR);
      float* zs = rb.tzs + wp * WR;
      warp_forward<T, RAW, false, HEADS, true>(tw, rb, st, wp, s0, n, 0, x, dirs, zs);
      if constexpr (HEADS) {
        const float* rbias = tw.b + tw.L.rgb_b;
        warp_mm<T>(SmemA<T>{warp_de<T>(tw.d, rb, wp, true), ldh}, H,
                   st.get(tw, fwd_mat<FWD>(tw.d, tw.L, st.n_fwd - 1)), 3 + F,
                   [=](int r, int c, float acc) {
                     if (r >= vr) return;
                     const size_t row = (size_t)s0 + r;
                     const O v = from_f<O>(acc + rbias[c]);
                     if (c < 3) rgb[row * 3 + c] = v;
                     else feat[row * F + (c - 3)] = v;
                   });
      }
      for (int r = threadIdx.x & (LANES - 1); r < vr; r += LANES)
        sigma[s0 + r] = from_f<O>(softplus(zs[r]));
      __syncwarp();
    }
}

// Shared-memory bytes of one block of the forward that K1/K5 launch in
// `mode`, in a pack dtype of ts bytes.
inline size_t fwd_smem(const Dims& d, int ts, int mode) {
  const Layout L = make_layout(d);
  return mode == TRANSIENT ? carve(d, false, mode, false, nullptr, nullptr)
         : mode == FULL    ? carve_field<SEQ_HEADS>(d, L, ts, nullptr, nullptr)
                           : carve_field<SEQ_SIGMA>(d, L, ts, nullptr, nullptr);
}

template <typename T, bool RAW, bool HEADS>
int launch_warp(int n, const void* x, const void* dirs, const void* w, const void* wt,
                const float* b, Dims d, void* sigma, void* rgb, void* feat, int blocks,
                void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = fwd_smem(d, sizeof(T), HEADS ? FULL : SIGMA);
  auto* kern = &field_warp_kernel<T, RAW, HEADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + BT - 1) / BT;
  const int grid = blocks > 0 && blocks < tiles ? blocks : tiles;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, wt, b, d), n, x, dirs,
               static_cast<O*>(sigma), static_cast<O*>(rgb), static_cast<O*>(feat));
  return (int)cudaGetLastError();
}

// K1/K5 in transient mode, on tower.cuh's tiles: sigma (N,), the split
// rgb (N, 3) and feature (N, F) heads, and the transient heads (N, 5):
// [sigma, rgb x3, beta] after softplus / sigmoid / softplus. x, dirs: emb
// (N, E) and embd (N, Ed) in T, or RAW the f32 points and directions
// (N, 3).
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
field_fwd_kernel(Tower<T> tw, int n, const void* __restrict__ x, const void* __restrict__ dirs,
                 Head<T, RAW>* __restrict__ sigma, Head<T, RAW>* __restrict__ rgb,
                 Head<T, RAW>* __restrict__ feat, Head<T, RAW>* __restrict__ trans) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  carve(tw.d, false, TRANSIENT, false, nefes_smem, &s);
  const int row0 = blockIdx.x * TR;
  const int valid = n - row0 < TR ? n - row0 : TR;
  const int F = tw.d.F;
  tile_inputs<T, RAW>(tw.d, s, x, dirs, true, row0, valid);
  tower_forward<T>(tw, s, TRANSIENT, false, 3 + F, [=](int r, int c, float v) {
    if (r >= valid) return;
    const size_t row = row0 + r;
    if (c < 3) rgb[row * 3 + c] = from_f<O>(v);
    else feat[row * F + (c - 3)] = from_f<O>(v);
  });
  for (int r = threadIdx.x; r < valid; r += blockDim.x)
    sigma[row0 + r] = from_f<O>(softplus(s.zs[r]));
  for (int i = threadIdx.x; i < valid * 5; i += blockDim.x)
    trans[(size_t)row0 * 5 + i] = from_f<O>(transient_head(s.tz[i], i % 5));
}

// Cotangents g_sigma (N,), g_rgb (N, 3), g_feat (N, F), g_trans (N, 5) in
// the head type; writes dx (N, E) and, unless SIGMA, ddirs (N, Ed) in T,
// or RAW d_pts and d_dirs (N, 3) in f32. With partials (need_dw): adds
// the weight gradients of tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// to partials[blockIdx.x] (nw + nb floats: the matrices, then the
// biases, at their blob offsets), with acts[blockIdx.x] (dw_scratch
// elements of T) as the activation scratch. Without, one tile per block.
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
field_bwd_kernel(Tower<T> tw, int n, int mode, const void* __restrict__ x,
                 const void* __restrict__ dirs, const Head<T, RAW>* __restrict__ g_sigma,
                 const Head<T, RAW>* __restrict__ g_rgb, const Head<T, RAW>* __restrict__ g_feat,
                 const Head<T, RAW>* __restrict__ g_trans, void* __restrict__ dx,
                 void* __restrict__ ddirs, float* __restrict__ partials, int nw, int nb,
                 T* __restrict__ acts) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  carve(tw.d, true, mode, partials != nullptr, nefes_smem, &s);
  DwOut<T> dw{nullptr, nullptr, nullptr};
  if (partials) {
    dw.part = partials + (size_t)blockIdx.x * (nw + nb);
    dw.part_b = dw.part + nw;
    dw.acts = acts + blockIdx.x * dw_scratch(tw.d);
  }
  const int F = tw.d.F;
  const int n_tiles = (n + TR - 1) / TR;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int valid = n - row0 < TR ? n - row0 : TR;
    tile_inputs<T, RAW>(tw.d, s, x, dirs, mode != SIGMA, row0, valid);
    tower_forward<T>(tw, s, mode, true, 0, [](int, int, float) {}, dw.acts);
    tower_backward<T>(
        tw, s, mode,
        [=](int r) { return r < valid ? to_f<O>(g_sigma[row0 + r]) : 0.f; },
        [=](int r, int c) {
          if (r >= valid) return 0.f;
          const size_t row = row0 + r;
          return c < 3 ? to_f<O>(g_rgb[row * 3 + c]) : to_f<O>(g_feat[row * F + (c - 3)]);
        },
        [=](int r, int j) {
          return r < valid ? to_f<O>(g_trans[(size_t)(row0 + r) * 5 + j]) : 0.f;
        },
        dw);
    tile_input_grads<T, RAW>(tw.d, s, x, dirs, mode != SIGMA, dx, ddirs, row0, valid);
  }
}

// out[j] = sum over s < slices of part[s * n + j], in slice order.
__global__ void __launch_bounds__(NT)
dw_reduce_kernel(int slices, int n, const float* __restrict__ part, float* __restrict__ out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < slices; ++k) acc += part[(size_t)k * n + j];
    out[j] = acc;
  }
}

// K1/K5: sigma and full mode on the warp path, transient mode on
// tower.cuh's field_fwd_kernel.
template <typename T, bool RAW>
int launch_fwd(int n, int mode, const void* x, const void* dirs, const void* w, const void* wt,
               const float* b, Dims d, void* sigma, void* rgb, void* feat, void* trans,
               int blocks, void* stream) {
  using O = Head<T, RAW>;
  if (mode == SIGMA)
    return launch_warp<T, RAW, false>(n, x, dirs, w, wt, b, d, sigma, rgb, feat, blocks, stream);
  if (mode == FULL)
    return launch_warp<T, RAW, true>(n, x, dirs, w, wt, b, d, sigma, rgb, feat, blocks, stream);
  const size_t smem = fwd_smem(d, sizeof(T), mode);
  auto* kern = &field_fwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TR - 1) / TR;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, nullptr, b, d), n, x, dirs,
               static_cast<O*>(sigma), static_cast<O*>(rgb), static_cast<O*>(feat),
               static_cast<O*>(trans));
  return (int)cudaGetLastError();
}

template <typename T, bool RAW>
int launch_bwd(int n, int mode, const void* x, const void* dirs, const void* w, const void* wt,
               const float* b, Dims d, const void* g_sigma, const void* g_rgb,
               const void* g_feat, const void* g_trans, void* dx, void* ddirs, int slices,
               int nw, int nb, float* partials, void* acts, void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = carve(d, true, mode, partials != nullptr, nullptr, nullptr);
  auto* kern = &field_bwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = partials ? slices : (n + TR - 1) / TR;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, wt, b, d), n,
               mode, x, dirs, static_cast<const O*>(g_sigma), static_cast<const O*>(g_rgb),
               static_cast<const O*>(g_feat), static_cast<const O*>(g_trans), dx, ddirs,
               partials, nw, nb, static_cast<T*>(acts));
  return (int)cudaGetLastError();
}

template <bool RAW>
int field_fwd(int dtype, int mode, int n, const void* x, const void* dirs, const void* w,
              const void* wt, const float* b, Dims d, void* sigma, void* rgb, void* feat,
              void* trans, int blocks, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  if (mode < SIGMA || mode > TRANSIENT) return -2;
  return dtype == 1 ? launch_fwd<__nv_bfloat16, RAW>(n, mode, x, dirs, w, wt, b, d, sigma, rgb,
                                                     feat, trans, blocks, stream)
                    : launch_fwd<float, RAW>(n, mode, x, dirs, w, wt, b, d, sigma, rgb, feat,
                                             trans, blocks, stream);
}

#ifndef NEFES_EMULATE
// Blocks of the forward K1 (or, RAW, K5) launches in `mode` that one SM
// holds, from the occupancy calculator; -1 on an error.
template <typename T, bool RAW>
int fwd_blocks_per_sm(const Dims& d, int mode) {
  const size_t smem = fwd_smem(d, sizeof(T), mode);
  auto blocks = [&](auto kern) {
    int nb = -1;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, NT, smem) != cudaSuccess)
      return -1;
    return nb;
  };
  if (mode == SIGMA) return blocks(&field_warp_kernel<T, RAW, false>);
  if (mode == FULL) return blocks(&field_warp_kernel<T, RAW, true>);
  return blocks(&field_fwd_kernel<T, RAW>);
}
#endif

template <bool RAW>
int field_bwd(int dtype, int mode, int n, const void* x, const void* dirs, const void* w,
              const void* wt, const float* b, Dims d, const void* g_sigma, const void* g_rgb,
              const void* g_feat, const void* g_trans, void* dx, void* ddirs, int slices,
              int nw, int nb, float* partials, void* acts, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  if (mode < SIGMA || mode > TRANSIENT) return -2;
  if (partials && (slices <= 0 || acts == nullptr)) return -3;
  return dtype == 1
             ? launch_bwd<__nv_bfloat16, RAW>(n, mode, x, dirs, w, wt, b, d, g_sigma, g_rgb,
                                              g_feat, g_trans, dx, ddirs, slices, nw, nb,
                                              partials, acts, stream)
             : launch_bwd<float, RAW>(n, mode, x, dirs, w, wt, b, d, g_sigma, g_rgb, g_feat,
                                      g_trans, dx, ddirs, slices, nw, nb, partials, acts,
                                      stream);
}

}  // namespace nefes

using nefes::Dims;

// dtype: 0 = float32, 1 = bfloat16 (the pack dtype of the weights and, on
// the pre-embedded kernels, of inputs, outputs and cotangents). mode: 0 =
// "sigma", 1 = "full", 2 = "transient". The transient heads and their
// cotangents are one (n, 5) array each. The forward: embd is not read in
// sigma mode (it may be null); blocks, the size of the sigma and full
// modes' persistent grid (nefes_field_blocks_per_sm a multiprocessor, at
// most one a block tile of 128 samples; 0: one a block tile), is not read
// in transient mode.
extern "C" int nefes_field_fwd_pre(int dtype, int mode, int n, const void* emb,
                                   const void* embd, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, void* sigma, void* rgb, void* feat, void* trans,
                                   int blocks, void* stream) {
  return nefes::field_fwd<false>(dtype, mode, n, emb, embd, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                 trans, blocks, stream);
}

// partials: null for the frozen field (need_dw=False: slices, nw, nb and
// acts are not read), else `slices` zeroed f32 slices of nw + nb floats
// (nw matrix entries and nb biases of the blobs) and acts, `slices` x
// nefes_field_dw_scratch elements of the pack dtype; the launch then has
// `slices` blocks.
extern "C" int nefes_field_bwd_pre(int dtype, int mode, int n, const void* emb,
                                   const void* embd, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const void* g_sigma, const void* g_rgb,
                                   const void* g_feat, const void* g_trans, void* d_emb,
                                   void* d_embd, int slices, int nw, int nb, float* partials,
                                   void* acts, void* stream) {
  return nefes::field_bwd<false>(dtype, mode, n, emb, embd, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb,
                                 g_feat, g_trans, d_emb, d_embd, slices, nw, nb, partials,
                                 acts, stream);
}

// The raw-input kernels: pts, dirs (n, 3) f32; heads, their cotangents
// and d_pts, d_dirs (n, 3) in f32 whatever the pack dtype.
extern "C" int nefes_field_fwd_raw(int dtype, int mode, int n, const float* pts,
                                   const float* dirs, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, float* sigma, float* rgb, float* feat,
                                   float* trans, int blocks, void* stream) {
  return nefes::field_fwd<true>(dtype, mode, n, pts, dirs, w, wt, b,
                                Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                trans, blocks, stream);
}

extern "C" int nefes_field_bwd_raw(int dtype, int mode, int n, const float* pts,
                                   const float* dirs, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const float* g_sigma, const float* g_rgb,
                                   const float* g_feat, const float* g_trans, float* d_pts,
                                   float* d_dirs, int slices, int nw, int nb, float* partials,
                                   void* acts, void* stream) {
  return nefes::field_bwd<true>(dtype, mode, n, pts, dirs, w, wt, b,
                                Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb, g_feat,
                                g_trans, d_pts, d_dirs, slices, nw, nb, partials, acts,
                                stream);
}

// Elements of the pack dtype one block of a backward with dW needs as
// activation scratch.
extern "C" int nefes_field_dw_scratch(int depth, int width) {
  return (int)nefes::dw_scratch(Dims{depth, width, 0, 0, 0, 0});
}

// The weight gradients: out (n,) = the sum of `slices` partial slices
// part (slices, n), in slice order (f32).
extern "C" int nefes_field_dw_reduce(int slices, int n, const float* part, float* out,
                                     void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + nefes::NT - 1) / nefes::NT;
  NEFES_LAUNCH(nefes::dw_reduce_kernel, grid, 0, stream, slices, n, part, out);
  return (int)cudaGetLastError();
}

// Shared-memory bytes of one block of the forward K1/K5 launch in `mode`;
// dtype as above.
extern "C" int nefes_field_smem_bytes(int dtype, int mode, int depth, int width, int skipmask,
                                      int E, int Ed, int F) {
  return (int)nefes::fwd_smem(Dims{depth, width, skipmask, E, Ed, F}, dtype == 1 ? 2 : 4, mode);
}

// Blocks of the forward K1 (or, raw, K5) in `mode` that one SM holds, from
// the occupancy calculator (1 in the host build); -1 on an error.
extern "C" int nefes_field_blocks_per_sm(int dtype, int mode, int raw, int depth, int width,
                                         int skipmask, int E, int Ed, int F) {
#ifdef NEFES_EMULATE
  return 1;
#else
  using nefes::fwd_blocks_per_sm;
  using bf16 = __nv_bfloat16;
  const Dims d{depth, width, skipmask, E, Ed, F};
  if (mode < nefes::SIGMA || mode > nefes::TRANSIENT) return -1;
  if (dtype == 1)
    return raw ? fwd_blocks_per_sm<bf16, true>(d, mode) : fwd_blocks_per_sm<bf16, false>(d, mode);
  return raw ? fwd_blocks_per_sm<float, true>(d, mode) : fwd_blocks_per_sm<float, false>(d, mode);
#endif
}
