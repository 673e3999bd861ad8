// Fused NeRFH-NFF field on Hopper: the tower and its heads (forward) and
// the recompute backward, with or without the weight gradients, on
// pre-embedded rows (K1, K2) or on raw points and directions that each
// tile embeds itself (K5, K6); modes sigma, full and transient.
//
// K1 replaces _run_fwd_pre / _fwd_kernel_pre (nefes_tpu/kernels/
// fused_field.py:686-709, 402-416); K2 replaces _run_bwd_pre /
// _bwd_kernel_pre (fused_field.py:712-741, 419-459), need_dw False or
// True. K5 replaces _run_fwd / _fwd_kernel (fused_field.py:597-619,
// 332-338): the embedding prologue (tower.cuh embed_tile) in place of
// K1's row load, heads written in f32. K6 replaces _run_bwd / _bwd_kernel
// (fused_field.py:622-648, 341-367): K2 with f32 head cotangents and an
// epilogue (embed_backward_tile) that takes the embedding cotangents,
// still in shared memory, to d_pts / d_dirs, recomputing the phases
// instead of storing them. With need_dw the backward also gives one f32
// gradient per packed weight (the TPU kernel's VMEM accumulators,
// fused_field.py:354-358, 440-444, 634-637, 728-731): K2/K6 add each
// tile's into the f32 partial slice of their block (tower.cuh), and
// field_dw_reduce sums the slices in order.
// One block runs the tower over TR = 64 samples at a time; the forward
// and the frozen backward have one block per tile, the backward with dW
// a persistent grid of `slices` blocks. Bound on an H100: operations
// (about 0.26 MFLOP per sample in sigma mode, 0.33 in full mode, 0.37 in
// transient mode, roughly twice that for the frozen backward and three
// times with dW; the embedding adds about 1 kFLOP and 66 sin/cos per
// sample), not bytes (at most ~0.7 KB per sample, plus the partial
// slices: about 0.75 MB read and written per tile with dW). The design
// notes are in tower.cuh.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "tower.cuh"

namespace nefes {

// the type of the heads and their cotangents: the pack dtype T on the
// pre-embedded kernels, f32 on the raw-input ones (as the TPU kernels)
template <typename T, bool RAW>
using Head = typename std::conditional<RAW, float, T>::type;

// mode: SIGMA (sigma head only), FULL (sigma plus the split rgb (N, 3)
// and feature (N, F) heads) or TRANSIENT (those plus the transient heads
// (N, 5): [sigma, rgb x3, beta] after softplus / sigmoid / softplus).
// x, dirs: emb (N, E) and embd (N, Ed) in T, or RAW the f32 points and
// directions (N, 3).
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
field_fwd_kernel(Tower<T> tw, int n, int mode, const void* __restrict__ x,
                 const void* __restrict__ dirs, Head<T, RAW>* __restrict__ sigma,
                 Head<T, RAW>* __restrict__ rgb, Head<T, RAW>* __restrict__ feat,
                 Head<T, RAW>* __restrict__ trans) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  carve(tw.d, false, mode, false, nefes_smem, &s);
  const int row0 = blockIdx.x * TR;
  const int valid = n - row0 < TR ? n - row0 : TR;
  const int F = tw.d.F;
  tile_inputs<T, RAW>(tw.d, s, x, dirs, mode != SIGMA, row0, valid);
  tower_forward<T>(tw, s, mode, false, mode != SIGMA ? 3 + F : 0, [=](int r, int c, float v) {
    if (r >= valid) return;
    const size_t row = row0 + r;
    if (c < 3) rgb[row * 3 + c] = from_f<O>(v);
    else feat[row * F + (c - 3)] = from_f<O>(v);
  });
  for (int r = threadIdx.x; r < valid; r += blockDim.x)
    sigma[row0 + r] = from_f<O>(softplus(s.zs[r]));
  if (mode == TRANSIENT)
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

template <typename T, bool RAW>
int launch_fwd(int n, int mode, const void* x, const void* dirs, const void* w,
               const float* b, Dims d, void* sigma, void* rgb, void* feat, void* trans,
               void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = carve(d, false, mode, false, nullptr, nullptr);
  auto* kern = &field_fwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TR - 1) / TR;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, nullptr, b, d),
               n, mode, x, dirs, static_cast<O*>(sigma), static_cast<O*>(rgb),
               static_cast<O*>(feat), static_cast<O*>(trans));
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
              const float* b, Dims d, void* sigma, void* rgb, void* feat, void* trans,
              void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  if (mode < SIGMA || mode > TRANSIENT) return -2;
  return dtype == 1 ? launch_fwd<__nv_bfloat16, RAW>(n, mode, x, dirs, w, b, d, sigma, rgb,
                                                     feat, trans, stream)
                    : launch_fwd<float, RAW>(n, mode, x, dirs, w, b, d, sigma, rgb, feat,
                                             trans, stream);
}

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
// cotangents are one (n, 5) array each.
extern "C" int nefes_field_fwd_pre(int dtype, int mode, int n, const void* emb,
                                   const void* embd, const void* w, const float* b, int depth,
                                   int width, int skipmask, int E, int Ed, int F, void* sigma,
                                   void* rgb, void* feat, void* trans, void* stream) {
  return nefes::field_fwd<false>(dtype, mode, n, emb, embd, w, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                 trans, stream);
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
                                   const float* dirs, const void* w, const float* b, int depth,
                                   int width, int skipmask, int E, int Ed, int F, float* sigma,
                                   float* rgb, float* feat, float* trans, void* stream) {
  return nefes::field_fwd<true>(dtype, mode, n, pts, dirs, w, b,
                                Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                trans, stream);
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
