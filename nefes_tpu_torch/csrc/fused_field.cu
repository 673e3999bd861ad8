// Fused NeRFH-NFF field on Hopper: the tower and its heads (forward) and
// the frozen-field recompute backward, on pre-embedded rows (K1, K2) or on
// raw points and directions that each tile embeds itself (K5, K6).
//
// K1 replaces _run_fwd_pre / _fwd_kernel_pre (nefes_tpu/kernels/
// fused_field.py:686-709, 402-416); K2 replaces _run_bwd_pre /
// _bwd_kernel_pre (fused_field.py:712-741, 419-459) with need_dw=False.
// K5 replaces _run_fwd / _fwd_kernel (fused_field.py:597-619, 332-338):
// the embedding prologue (tower.cuh embed_tile) in place of K1's row
// load, heads written in f32. K6 replaces _run_bwd / _bwd_kernel
// (fused_field.py:622-648, 341-367) with need_dw=False: K2 with f32 head
// cotangents and an epilogue (embed_backward_tile) that takes the
// embedding cotangents, still in shared memory, to d_pts / d_dirs,
// recomputing the phases instead of storing them.
// One block runs the tower over TR = 64 samples; the grid covers N
// samples with the ragged last tile masked. Bound on an H100: operations
// (about 0.26 MFLOP per sample in sigma mode, 0.33 in full mode, and
// roughly twice that for the backward; the embedding adds about 1 kFLOP
// and 66 sin/cos per sample), not bytes (at most ~0.7 KB per sample). The
// design notes are in tower.cuh.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "tower.cuh"

namespace nefes {

// the type of the heads and their cotangents: the pack dtype T on the
// pre-embedded kernels, f32 on the raw-input ones (as the TPU kernels)
template <typename T, bool RAW>
using Head = typename std::conditional<RAW, float, T>::type;

// modes: full = 0 is "sigma" (sigma head only), 1 is "full" (sigma plus
// the split rgb (N, 3) and feature (N, F) heads). x, dirs: emb (N, E) and
// embd (N, Ed) in T, or RAW the f32 points and directions (N, 3).
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
field_fwd_kernel(Tower<T> tw, int n, int full, const void* __restrict__ x,
                 const void* __restrict__ dirs, Head<T, RAW>* __restrict__ sigma,
                 Head<T, RAW>* __restrict__ rgb, Head<T, RAW>* __restrict__ feat) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  carve(tw.d, false, nefes_smem, &s);
  const int row0 = blockIdx.x * TR;
  const int valid = n - row0 < TR ? n - row0 : TR;
  const int F = tw.d.F;
  tile_inputs<T, RAW>(tw.d, s, x, dirs, full, row0, valid);
  tower_forward<T>(tw, s, full, false, full ? 3 + F : 0, [=](int r, int c, float v) {
    if (r >= valid) return;
    const size_t row = row0 + r;
    if (c < 3) rgb[row * 3 + c] = from_f<O>(v);
    else feat[row * F + (c - 3)] = from_f<O>(v);
  });
  for (int r = threadIdx.x; r < valid; r += blockDim.x)
    sigma[row0 + r] = from_f<O>(softplus(s.zs[r]));
}

// Cotangents g_sigma (N,), g_rgb (N, 3), g_feat (N, F) in the head type;
// writes dx (N, E) and, in full mode, ddirs (N, Ed) in T, or RAW d_pts
// and d_dirs (N, 3) in f32.
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
field_bwd_kernel(Tower<T> tw, int n, int full, const void* __restrict__ x,
                 const void* __restrict__ dirs, const Head<T, RAW>* __restrict__ g_sigma,
                 const Head<T, RAW>* __restrict__ g_rgb, const Head<T, RAW>* __restrict__ g_feat,
                 void* __restrict__ dx, void* __restrict__ ddirs) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  carve(tw.d, true, nefes_smem, &s);
  const int row0 = blockIdx.x * TR;
  const int valid = n - row0 < TR ? n - row0 : TR;
  const int F = tw.d.F;
  tile_inputs<T, RAW>(tw.d, s, x, dirs, full, row0, valid);
  tower_forward<T>(tw, s, full, true, 0, [](int, int, float) {});
  tower_backward<T>(
      tw, s, full,
      [=](int r) { return r < valid ? to_f<O>(g_sigma[row0 + r]) : 0.f; },
      [=](int r, int c) {
        if (r >= valid) return 0.f;
        const size_t row = row0 + r;
        return c < 3 ? to_f<O>(g_rgb[row * 3 + c]) : to_f<O>(g_feat[row * F + (c - 3)]);
      });
  tile_input_grads<T, RAW>(tw.d, s, x, dirs, full, dx, ddirs, row0, valid);
}

template <typename T, bool RAW>
int launch_fwd(int n, int full, const void* x, const void* dirs, const void* w,
               const float* b, Dims d, void* sigma, void* rgb, void* feat, void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = carve(d, false, nullptr, nullptr);
  auto* kern = &field_fwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TR - 1) / TR;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, nullptr, b, d),
               n, full, x, dirs, static_cast<O*>(sigma), static_cast<O*>(rgb),
               static_cast<O*>(feat));
  return (int)cudaGetLastError();
}

template <typename T, bool RAW>
int launch_bwd(int n, int full, const void* x, const void* dirs, const void* w, const void* wt,
               const float* b, Dims d, const void* g_sigma, const void* g_rgb,
               const void* g_feat, void* dx, void* ddirs, void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = carve(d, true, nullptr, nullptr);
  auto* kern = &field_bwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TR - 1) / TR;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, wt, b, d), n,
               full, x, dirs, static_cast<const O*>(g_sigma), static_cast<const O*>(g_rgb),
               static_cast<const O*>(g_feat), dx, ddirs);
  return (int)cudaGetLastError();
}

template <bool RAW>
int field_fwd(int dtype, int full, int n, const void* x, const void* dirs, const void* w,
              const float* b, Dims d, void* sigma, void* rgb, void* feat, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  return dtype == 1 ? launch_fwd<__nv_bfloat16, RAW>(n, full, x, dirs, w, b, d, sigma, rgb,
                                                     feat, stream)
                    : launch_fwd<float, RAW>(n, full, x, dirs, w, b, d, sigma, rgb, feat,
                                             stream);
}

template <bool RAW>
int field_bwd(int dtype, int full, int n, const void* x, const void* dirs, const void* w,
              const void* wt, const float* b, Dims d, const void* g_sigma, const void* g_rgb,
              const void* g_feat, void* dx, void* ddirs, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  return dtype == 1
             ? launch_bwd<__nv_bfloat16, RAW>(n, full, x, dirs, w, wt, b, d, g_sigma, g_rgb,
                                              g_feat, dx, ddirs, stream)
             : launch_bwd<float, RAW>(n, full, x, dirs, w, wt, b, d, g_sigma, g_rgb, g_feat,
                                      dx, ddirs, stream);
}

}  // namespace nefes

using nefes::Dims;

// dtype: 0 = float32, 1 = bfloat16 (the pack dtype of the weights and, on
// the pre-embedded kernels, of inputs, outputs and cotangents). full: 0 =
// "sigma" mode, 1 = "full" mode.
extern "C" int nefes_field_fwd_pre(int dtype, int full, int n, const void* emb,
                                   const void* embd, const void* w, const float* b, int depth,
                                   int width, int skipmask, int E, int Ed, int F, void* sigma,
                                   void* rgb, void* feat, void* stream) {
  return nefes::field_fwd<false>(dtype, full, n, emb, embd, w, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                 stream);
}

extern "C" int nefes_field_bwd_pre(int dtype, int full, int n, const void* emb,
                                   const void* embd, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const void* g_sigma, const void* g_rgb,
                                   const void* g_feat, void* d_emb, void* d_embd, void* stream) {
  return nefes::field_bwd<false>(dtype, full, n, emb, embd, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb,
                                 g_feat, d_emb, d_embd, stream);
}

// The raw-input kernels: pts, dirs (n, 3) f32; heads, their cotangents
// and d_pts, d_dirs (n, 3) in f32 whatever the pack dtype.
extern "C" int nefes_field_fwd_raw(int dtype, int full, int n, const float* pts,
                                   const float* dirs, const void* w, const float* b, int depth,
                                   int width, int skipmask, int E, int Ed, int F, float* sigma,
                                   float* rgb, float* feat, void* stream) {
  return nefes::field_fwd<true>(dtype, full, n, pts, dirs, w, b,
                                Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                stream);
}

extern "C" int nefes_field_bwd_raw(int dtype, int full, int n, const float* pts,
                                   const float* dirs, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const float* g_sigma, const float* g_rgb,
                                   const float* g_feat, float* d_pts, float* d_dirs,
                                   void* stream) {
  return nefes::field_bwd<true>(dtype, full, n, pts, dirs, w, wt, b,
                                Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb, g_feat,
                                d_pts, d_dirs, stream);
}
