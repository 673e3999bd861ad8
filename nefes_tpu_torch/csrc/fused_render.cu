// Composite-fused fine render on Hopper: K3 (forward) and K4 (frozen-field
// backward) on pre-embedded inputs, K7 and K8 on raw points and
// directions that each tile embeds itself.
//
// K3 replaces run_fwd / _render_fwd_kernel_pre of make_fused_render_pre
// (nefes_tpu/kernels/fused_render.py:363-378, 276-295); K4 replaces
// run_bwd / _render_bwd_kernel_pre (fused_render.py:380-399, 298-351).
// K7 replaces run_fwd / _render_fwd_kernel of make_fused_render
// (fused_render.py:208-223, 116-133) and K8 its run_bwd /
// _render_bwd_kernel (fused_render.py:225-244, 136-195): the same two
// kernels with the embedding computed in the kernel in place of the row
// loads and, in K8, the chain-rule epilogue giving d_pts and d_dirs per
// sample (the phases recomputed from the points, not kept).
//
// One block renders one ray. The TPU kernel's selector-matmul folds and
// triangular-matmul cumsum are Mosaic layout workarounds; here the
// transmittance is a prefix sum over the ray's samples. Bound on an H100:
// operations (about 0.33 MFLOP per sample forward, twice that backward);
// the per-ray output is only 3 + F + 2 floats.
//
// K3/K7 (render_fwd_kernel): the tower of tower.cuh over the ray's S
// samples in tiles of TR = 64, the composite in one thread.
//
// K4/K8 (render_bwd_kernel): render_bwd.cuh's path. What bounded the
// first version (42.8 ms for 4,800 rays x 128 samples on an H100 at
// 700 W, 0.94 % of the bound) was surplus and latency, not the tensor
// cores: it ran the tower forward twice per sample (once for sigma and
// rgb, once per tile for the ReLU bits), held a whole SM's shared memory
// in f32 activations, ran the composite backward in one thread while 255
// waited, and fed mma.sync from f32 shared memory with bank conflicts and
// B from L1. Now pass 1 runs the forward once per sample and keeps, per
// sample, the ReLU bits of every hidden layer and of the dir layer, the
// sigma pre-activation and rgb (D8/W128: 34 words and 4 floats, 152
// bytes); warp 0 runs the composite and its backward as warp scans; pass
// 2 runs only the tower backward from that state. Each warp owns 16
// samples through every layer, activations in bf16; the products are
// mma.sync fed by ldmatrix from conflict-free padded rows, the weights
// staged matrix by matrix by cp.async into two shared-memory stages, the
// next loading while the current one's products run. The per-sample state
// (172 bytes with the composite's) stays in shared memory for the whole
// ray, beside the fixed stages and warp tiles: at D8/W128 a block holds
// 269 samples in bf16 and 204 in f32 (K3/K7: 237 in either);
// _check_render refuses more.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "render_bwd.cuh"

namespace nefes {

// per-ray buffers of the forward after the tower tile in shared memory
struct RaySmem {
  float* sig;    // S   sigma (post-softplus)
  float* z;      // S
  float* wgt;    // S   composite weights
  float* rf;     // S x C rgb+features
};

__host__ __device__ inline size_t carve_ray(const Dims& d, int S, char* base, Smem* s,
                                            RaySmem* rs) {
  size_t off = carve(d, false, FULL, false, base, s);
  RaySmem t;
  t.sig = take(base, &off, S);
  t.z = take(base, &off, S);
  t.wgt = take(base, &off, S);
  t.rf = take(base, &off, (size_t)S * (3 + d.F));
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
// T_i = exp(sum_{j<i} log(max(1 - alpha_j, 1e-10))). One thread.
__device__ inline void composite_weights(const RaySmem& rs, int S) {
  float log_t = 0.f;
  for (int i = 0; i < S; ++i) {
    const float delta = i + 1 < S ? rs.z[i + 1] - rs.z[i] : DELTA_INF;
    const float alpha = 1.f - expf(-delta * rs.sig[i]);
    rs.wgt[i] = alpha * expf(log_t);
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
  carve_ray(tw.d, S, nefes_smem, &s, &rs);
  const int ray = blockIdx.x;
  const int C = 3 + tw.d.F;
  for (int i = threadIdx.x; i < S; i += blockDim.x) rs.z[i] = z[(size_t)ray * S + i];
  ray_forward<T, RAW>(tw, s, rs, S, (size_t)ray * S, x, dirs, C);

  if (threadIdx.x == 0) composite_weights(rs, S);
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
__global__ void __launch_bounds__(NT, 1)
render_bwd_kernel(Tower<T> tw, int S, const void* __restrict__ x, const void* __restrict__ dirs,
                  const float* __restrict__ z, const float* __restrict__ g,
                  void* __restrict__ dx, void* __restrict__ ddirs, float* __restrict__ d_z) {
  extern __shared__ __align__(16) char nefes_smem[];
  RayBwd rb;
  carve_bwd(tw.d, tw.L, sizeof(T), S, nefes_smem, &rb);
  const int C = 3 + tw.d.F, tiles = (S + BT - 1) / BT, warp = threadIdx.x >> 5;
  const size_t sample0 = (size_t)blockIdx.x * S;
  Stager<T> st(tw, rb, tiles);
  for (int i = threadIdx.x; i < S; i += blockDim.x) rb.z[i] = z[sample0 + i];
  for (int c = threadIdx.x; c < C + 2; c += blockDim.x) rb.gr[c] = g[blockIdx.x * (C + 2) + c];

  for (int t = 0; t < tiles; ++t)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP)
      warp_forward<T, RAW>(tw, rb, st, wp, t * BT + wp * WR, S, sample0, x, dirs);
  __syncthreads();
  if (warp == 0) ray_composite(rb, S, C, d_z + sample0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP)
      warp_backward<T, RAW>(tw, rb, st, wp, t * BT + wp * WR, S, sample0, x, dirs, dx, ddirs);
}

template <typename T, bool RAW>
int launch_fwd(int R, int S, const void* x, const void* dirs, const float* z, const void* w,
               const float* b, Dims d, float* out, void* stream) {
  const size_t smem = carve_ray(d, S, nullptr, nullptr, nullptr);
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
  const size_t smem = carve_bwd(d, make_layout(d), sizeof(T), S, nullptr, nullptr);
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

// Shared-memory bytes one block of each kernel asks for; dtype as above
// (the forward's do not depend on it).
extern "C" int nefes_render_smem_bytes(int dtype, int backward, int S, int depth, int width,
                                       int skipmask, int E, int Ed, int F) {
  const Dims d{depth, width, skipmask, E, Ed, F};
  return (int)(backward ? nefes::carve_bwd(d, nefes::make_layout(d), dtype == 1 ? 2 : 4, S,
                                           nullptr, nullptr)
                        : nefes::carve_ray(d, S, nullptr, nullptr, nullptr));
}

// Blocks of the backward (K4, or RAW K8) one SM holds at S samples per
// ray, from the occupancy calculator; -1 on an error.
extern "C" int nefes_render_bwd_blocks_per_sm(int dtype, int raw, int S, int depth, int width,
                                              int skipmask, int E, int Ed, int F) {
#ifdef NEFES_EMULATE
  return 1;
#else
  const Dims d{depth, width, skipmask, E, Ed, F};
  const size_t smem =
      nefes::carve_bwd(d, nefes::make_layout(d), dtype == 1 ? 2 : 4, S, nullptr, nullptr);
  auto blocks = [&](auto kern) {
    int n = -1;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, nefes::NT, smem) != cudaSuccess)
      return -1;
    return n;
  };
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return raw ? blocks(&nefes::render_bwd_kernel<bf16, true>)
               : blocks(&nefes::render_bwd_kernel<bf16, false>);
  return raw ? blocks(&nefes::render_bwd_kernel<float, true>)
             : blocks(&nefes::render_bwd_kernel<float, false>);
#endif
}
