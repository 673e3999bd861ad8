// Composite-fused fine render on Hopper: K3 (forward) and K4 (frozen-field
// recompute backward) on pre-embedded inputs, K7 and K8 on raw points and
// directions that each tile embeds itself.
//
// K3 replaces run_fwd / _render_fwd_kernel_pre of make_fused_render_pre
// (nefes_tpu/kernels/fused_render.py:363-378, 276-295); K4 replaces
// run_bwd / _render_bwd_kernel_pre (fused_render.py:380-399, 298-351).
// K7 replaces run_fwd / _render_fwd_kernel of make_fused_render
// (fused_render.py:208-223, 116-133) and K8 its run_bwd /
// _render_bwd_kernel (fused_render.py:225-244, 136-195): the same two
// kernels with tower.cuh's embedding prologue in place of the row loads
// and, in K8, its chain-rule epilogue giving d_pts and d_dirs per sample
// (the phases recomputed, not kept: shared memory is as in K3/K4).
//
// One block renders one ray: the tower (tower.cuh) runs over the ray's S
// samples in tiles of TR = 64, and the volume composite runs inside the
// block. The TPU kernel's selector-matmul folds and triangular-matmul
// cumsum are Mosaic layout workarounds; here the transmittance scan and
// the backward's suffix sum are a serial loop over the ray's S samples in
// one thread (microseconds, against the tower's milliseconds per block).
// Bound on an H100: operations, as for the field kernels; the per-ray
// output is only 3 + F + 2 floats.
//
// K4 keeps no per-sample state between its two passes beyond sigma, rgb,
// the composite weights and the sigma cotangent: pass 1 recomputes sigma
// and rgb for every sample (the composite backward needs the whole ray),
// pass 2 recomputes the tower per tile with its ReLU bits and runs the
// tower backward.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "tower.cuh"

namespace nefes {

// per-ray buffers after the tower tile in shared memory
struct RaySmem {
  float* sig;    // S   sigma (post-softplus)
  float* z;      // S
  float* wgt;    // S   composite weights
  float* rf;     // S x C rgb+features (forward) | S x 3 rgb (backward)
  float* dsig;   // S   sigma cotangent (backward)
  float* tmp;    // S   transmittance, then delta cotangent (backward)
};

__host__ __device__ inline size_t carve_ray(const Dims& d, bool backward, int S, char* base,
                                            Smem* s, RaySmem* rs) {
  size_t off = carve(d, backward, FULL, false, base, s);
  const int C = 3 + d.F;
  RaySmem t;
  t.sig = take(base, &off, S);
  t.z = take(base, &off, S);
  t.wgt = take(base, &off, S);
  t.rf = take(base, &off, (size_t)S * (backward ? 3 : C));
  t.dsig = backward ? take(base, &off, S) : nullptr;
  t.tmp = backward ? take(base, &off, S) : nullptr;
  if (rs) *rs = t;
  return off;
}

// Run the forward tower over the ray's samples, tile by tile, keeping
// sigma and the first rf_cols columns of the rgb/feature head per sample.
// x, dirs: the (R*S, E) / (R*S, Ed) embeddings in T, or RAW the (R*S, 3)
// f32 points and directions.
template <typename T, bool RAW>
__device__ void ray_forward(const Tower<T>& tw, const Smem& s, const RaySmem& rs, int S,
                            size_t sample0, const void* x, const void* dirs, int rf_cols) {
  for (int t0 = 0; t0 < S; t0 += TR) {
    const int valid = S - t0 < TR ? S - t0 : TR;
    tile_inputs<T, RAW>(tw.d, s, x, dirs, true, sample0 + t0, valid);
    float* rf = rs.rf;
    tower_forward<T>(tw, s, FULL, false, rf_cols, [=](int r, int c, float v) {
      if (r < valid) rf[(t0 + r) * rf_cols + c] = v;
    });
    for (int r = threadIdx.x; r < valid; r += blockDim.x) rs.sig[t0 + r] = softplus(s.zs[r]);
    __syncthreads();
  }
}

// Composite weights w_i = alpha_i * T_i with log-space transmittance
// T_i = exp(sum_{j<i} log(max(1 - alpha_j, 1e-10))); T_i goes to trans
// when given. One thread.
__device__ inline void composite_weights(const RaySmem& rs, int S, float* trans) {
  float log_t = 0.f;
  for (int i = 0; i < S; ++i) {
    const float delta = i + 1 < S ? rs.z[i + 1] - rs.z[i] : DELTA_INF;
    const float alpha = 1.f - expf(-delta * rs.sig[i]);
    const float t = expf(log_t);
    if (trans) trans[i] = t;
    rs.wgt[i] = alpha * t;
    log_t += logf(fmaxf(1.f - alpha, LOG_EPS));
  }
}

// out (R, C + 2) f32: [sum_s w_s * rgbfeat_s | depth | acc]
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
render_fwd_kernel(Tower<T> tw, int S, const void* __restrict__ x, const void* __restrict__ dirs,
                  const float* __restrict__ z, float* __restrict__ out) {
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  RaySmem rs;
  carve_ray(tw.d, false, S, nefes_smem, &s, &rs);
  const int ray = blockIdx.x;
  const int C = 3 + tw.d.F;
  for (int i = threadIdx.x; i < S; i += blockDim.x) rs.z[i] = z[(size_t)ray * S + i];
  ray_forward<T, RAW>(tw, s, rs, S, (size_t)ray * S, x, dirs, C);

  if (threadIdx.x == 0) composite_weights(rs, S, nullptr);
  __syncthreads();
  float* o = out + (size_t)ray * (C + 2);
  for (int c = threadIdx.x; c < C + 2; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < S; ++i) {
      const float v = c < C ? rs.rf[i * C + c] : (c == C ? rs.z[i] : 1.f);
      acc = fmaf(rs.wgt[i], v, acc);
    }
    o[c] = acc;
  }
}

// g (R, C + 2) f32 cotangent of the forward output; writes dx, ddirs:
// d_emb (R*S, E), d_embd (R*S, Ed) in T or, RAW, d_pts and d_dirs
// (R*S, 3) f32; and d_z (R, S) f32. Stop-gradient rule: only the rgb
// channels, depth and acc feed the cotangent of the composite weights;
// the features reach only the head.
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT)
render_bwd_kernel(Tower<T> tw, int S, const void* __restrict__ x, const void* __restrict__ dirs,
                  const float* __restrict__ z, const float* __restrict__ g,
                  void* __restrict__ dx, void* __restrict__ ddirs, float* __restrict__ d_z) {
  extern __shared__ __align__(16) char nefes_smem[];
  Smem s;
  RaySmem rs;
  carve_ray(tw.d, true, S, nefes_smem, &s, &rs);
  const int ray = blockIdx.x;
  const int C = 3 + tw.d.F;
  const size_t sample0 = (size_t)ray * S;
  const float* gr = g + (size_t)ray * (C + 2);
  for (int i = threadIdx.x; i < S; i += blockDim.x) rs.z[i] = z[sample0 + i];
  ray_forward<T, RAW>(tw, s, rs, S, sample0, x, dirs, 3);

  if (threadIdx.x == 0) {
    composite_weights(rs, S, rs.tmp);
    const float g_depth = gr[C], g_acc = gr[C + 1];
    float suffix = 0.f;   // sum_{k > i} d_w_k * w_k
    for (int i = S - 1; i >= 0; --i) {
      const float* rgb = rs.rf + i * 3;
      const float d_w = (rgb[0] * gr[0] + rgb[1] * gr[1] + rgb[2] * gr[2])
                        + rs.z[i] * g_depth + g_acc;
      const float delta = i + 1 < S ? rs.z[i + 1] - rs.z[i] : DELTA_INF;
      const float sig = rs.sig[i];
      const float alpha = 1.f - expf(-delta * sig);
      const float d_alpha = d_w * rs.tmp[i] - suffix / fmaxf(1.f - alpha, LOG_EPS);
      suffix += d_w * rs.wgt[i];
      const float exp_term = expf(-delta * sig);
      rs.dsig[i] = d_alpha * delta * exp_term;
      // the last delta is the constant tail: no z cotangent
      rs.tmp[i] = i + 1 < S ? d_alpha * sig * exp_term : 0.f;
    }
    // delta_i = z_{i+1} - z_i  =>  d_z_i = w_i g_depth + d_delta_{i-1} - d_delta_i
    for (int i = 0; i < S; ++i)
      d_z[sample0 + i] = (rs.wgt[i] * g_depth + (i > 0 ? rs.tmp[i - 1] : 0.f)) - rs.tmp[i];
  }
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += TR) {
    const int valid = S - t0 < TR ? S - t0 : TR;
    const size_t row0 = sample0 + t0;
    tile_inputs<T, RAW>(tw.d, s, x, dirs, true, row0, valid);
    tower_forward<T>(tw, s, FULL, true, 0, [](int, int, float) {});
    const float* dsig = rs.dsig + t0;
    const float* wgt = rs.wgt + t0;
    tower_backward<T>(
        tw, s, FULL, [=](int r) { return r < valid ? dsig[r] : 0.f; },
        [=](int r, int c) { return r < valid ? wgt[r] * gr[c] : 0.f; }, NoGrad{},
        DwOut<T>{nullptr, nullptr, nullptr});
    tile_input_grads<T, RAW>(tw.d, s, x, dirs, true, dx, ddirs, row0, valid);
  }
}

template <typename T, bool RAW>
int launch_fwd(int R, int S, const void* x, const void* dirs, const float* z, const void* w,
               const float* b, Dims d, float* out, void* stream) {
  const size_t smem = carve_ray(d, false, S, nullptr, nullptr, nullptr);
  auto* kern = &render_fwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  NEFES_LAUNCH(kern, R, smem, stream, make_tower<T>(w, nullptr, b, d), S, x, dirs, z, out);
  return (int)cudaGetLastError();
}

template <typename T, bool RAW>
int launch_bwd(int R, int S, const void* x, const void* dirs, const float* z, const void* w,
               const void* wt, const float* b, Dims d, const float* g, void* dx, void* ddirs,
               float* d_z, void* stream) {
  const size_t smem = carve_ray(d, true, S, nullptr, nullptr, nullptr);
  auto* kern = &render_bwd_kernel<T, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  NEFES_LAUNCH(kern, R, smem, stream, make_tower<T>(w, wt, b, d), S, x, dirs, z, g, dx, ddirs,
               d_z);
  return (int)cudaGetLastError();
}

template <bool RAW>
int render_fwd(int dtype, int R, int S, const void* x, const void* dirs, const float* z,
               const void* w, const float* b, Dims d, float* out, void* stream) {
  if (R <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  return dtype == 1 ? launch_fwd<__nv_bfloat16, RAW>(R, S, x, dirs, z, w, b, d, out, stream)
                    : launch_fwd<float, RAW>(R, S, x, dirs, z, w, b, d, out, stream);
}

template <bool RAW>
int render_bwd(int dtype, int R, int S, const void* x, const void* dirs, const float* z,
               const void* w, const void* wt, const float* b, Dims d, const float* g, void* dx,
               void* ddirs, float* d_z, void* stream) {
  if (R <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  return dtype == 1 ? launch_bwd<__nv_bfloat16, RAW>(R, S, x, dirs, z, w, wt, b, d, g, dx,
                                                     ddirs, d_z, stream)
                    : launch_bwd<float, RAW>(R, S, x, dirs, z, w, wt, b, d, g, dx, ddirs, d_z,
                                             stream);
}

}  // namespace nefes

using nefes::Dims;

// dtype: 0 = float32, 1 = bfloat16 (pack dtype of weights, embeddings and
// embedding cotangents); z, out, g and d_z are float32.
extern "C" int nefes_render_fwd_pre(int dtype, int R, int S, const void* emb, const void* embd,
                                    const float* z, const void* w, const float* b, int depth,
                                    int width, int skipmask, int E, int Ed, int F, float* out,
                                    void* stream) {
  return nefes::render_fwd<false>(dtype, R, S, emb, embd, z, w, b,
                                  Dims{depth, width, skipmask, E, Ed, F}, out, stream);
}

extern "C" int nefes_render_bwd_pre(int dtype, int R, int S, const void* emb, const void* embd,
                                    const float* z, const void* w, const void* wt,
                                    const float* b, int depth, int width, int skipmask, int E,
                                    int Ed, int F, const float* g, void* d_emb, void* d_embd,
                                    float* d_z, void* stream) {
  return nefes::render_bwd<false>(dtype, R, S, emb, embd, z, w, wt, b,
                                  Dims{depth, width, skipmask, E, Ed, F}, g, d_emb, d_embd, d_z,
                                  stream);
}

// The raw-input kernels: pts, dirs (R*S, 3) f32 (dirs per sample), and
// d_pts, d_dirs (R*S, 3) f32, whatever the pack dtype.
extern "C" int nefes_render_fwd_raw(int dtype, int R, int S, const float* pts,
                                    const float* dirs, const float* z, const void* w,
                                    const float* b, int depth, int width, int skipmask, int E,
                                    int Ed, int F, float* out, void* stream) {
  return nefes::render_fwd<true>(dtype, R, S, pts, dirs, z, w, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, out, stream);
}

extern "C" int nefes_render_bwd_raw(int dtype, int R, int S, const float* pts,
                                    const float* dirs, const float* z, const void* w,
                                    const void* wt, const float* b, int depth, int width,
                                    int skipmask, int E, int Ed, int F, const float* g,
                                    float* d_pts, float* d_dirs, float* d_z, void* stream) {
  return nefes::render_bwd<true>(dtype, R, S, pts, dirs, z, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, g, d_pts, d_dirs, d_z,
                                 stream);
}

// Shared-memory bytes one block of each kernel asks for.
extern "C" int nefes_render_smem_bytes(int backward, int S, int depth, int width, int skipmask,
                                       int E, int Ed, int F) {
  const Dims d{depth, width, skipmask, E, Ed, F};
  return (int)nefes::carve_ray(d, backward != 0, S, nullptr, nullptr, nullptr);
}
