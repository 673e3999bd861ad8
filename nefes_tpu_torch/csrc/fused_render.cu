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
// One block renders one ray, on render_bwd.cuh's warp path. The TPU
// kernel's selector-matmul folds and triangular-matmul cumsum are Mosaic
// layout workarounds; here the transmittance is a prefix sum over the
// ray's samples, as warp scans. Bound on an H100: operations (about 0.33
// MFLOP per sample forward, twice that backward); the per-ray output is
// only 3 + F + 2 floats.
//
// K3/K7 (render_fwd_kernel): the block walks its ray in block tiles of BT
// = 128 samples. Each warp runs its 16 rows to the dir layer
// (warp_forward, keeping nothing for a backward); warp 0 turns the tile's
// sigmas into composite weights, carrying the log transmittance from tile
// to tile; each warp adds its rows' w de, w z and w into its f32 partials.
// The rgb/feature head is linear, so it runs once per ray on the weighted
// sum: sum_s w_s (de_s W + b) = (sum_s w_s de_s) W + (sum_s w_s) b, 64 x
// 131 multiply-adds a ray in place of one 16 x 64 x 131 product a warp
// and tile. What bounded the first version (16.0 ms for 4,800 rays x 128
// samples on an H100 at 700 W, 5.5 x a cuBLAS chain of the same products)
// was its f32 tiles of 64 rows through tower.cuh, weights read through L1,
// the whole SM's shared memory held per ray (the rgb and features of every
// sample) and the composite run in one thread while 255 waited. The block
// keeps O(BT) state, whatever the ray's length: no sample limit.
//
// K4/K8 (render_bwd_kernel): pass 1 runs the forward once per sample
// (warp_forward, KEEP) and keeps, per sample, the ReLU bits of every
// hidden layer and of the dir layer, the sigma pre-activation and rgb
// (D8/W128: 34 words and 4 floats, 152 bytes); warp 0 runs the composite
// and its backward as warp scans; pass 2 runs only the tower backward from
// that state. The per-sample state (172 bytes with the composite's) stays
// in shared memory for the whole ray, beside the fixed stages and warp
// tiles, while it fits: at D8/W128 a block holds 269 samples in bf16 and
// 204 in f32. Past that the block keeps it in its slice of a global
// scratch of state_bytes a ray that the caller allocates
// (nefes_render_bwd_scratch_bytes), so the backward too takes any S.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "render_bwd.cuh"

namespace nefes {

// Warp wp's rows [s0, s0 + 16) of a tile: their composite weights w (the
// tile's, from the warp's first row) times the dir layer's output de, z
// and 1, added into the warp's f32 partials part (H + 2). Lane c owns
// column c, summing its rows in order.
template <typename T>
__device__ __forceinline__ void warp_accumulate(const Dims& d, const RayBufs& rb, int wp, int s0,
                                                int S, const float* w, const float* z) {
  const int H = d.width / 2, ldh = ld_of(H);
  const int vr = S - s0 < 0 ? 0 : (S - s0 < WR ? S - s0 : WR);
  const T* de = warp_de<T>(d, rb, wp);
  float* part = rb.part + wp * (H + 2);
  for (int c = threadIdx.x & (LANES - 1); c < H + 2; c += LANES) {
    float acc = 0.f;
    for (int r = 0; r < vr; ++r)
      acc = fmaf(w[r], c < H ? to_f<T>(de[r * ldh + c]) : (c == H ? z[s0 + r] : 1.f), acc);
    part[c] += acc;
  }
  __syncwarp();
}

// out (R, C + 2) f32: [sum_s w_s rgbfeat_s | depth | acc]
template <typename T, bool RAW>
__global__ void __launch_bounds__(NT, 1)
render_fwd_kernel(Tower<T> tw, int S, const void* __restrict__ x, const void* __restrict__ dirs,
                  const float* __restrict__ z, float* __restrict__ out) {
  extern __shared__ __align__(16) char nefes_smem[];
  RayBufs rb;
  carve_block(tw.d, tw.L, sizeof(T), false, 0, nefes_smem, &rb);
  const int H = tw.d.width / 2, P = H + 2, C = 3 + tw.d.F;
  const int tiles = (S + BT - 1) / BT, warp = threadIdx.x >> 5;
  const size_t sample0 = (size_t)blockIdx.x * S;
  const float* zr = z + sample0;
  Stager<T> st(tw, rb, tiles, false);
  for (int i = threadIdx.x; i < WARPS * P; i += blockDim.x) rb.part[i] = 0.f;
  float carry = 0.f;   // warp 0: the log transmittance past the tiles so far
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * BT, t1 = S - t0 < BT ? S : t0 + BT;
    for (int wp = warp; wp < WARPS; wp += WARP_STEP)
      warp_forward<T, RAW, KEEP_NONE>(tw, rb, st, wp, t0 + wp * WR, S, sample0, x, dirs,
                                      rb.tzs + wp * WR);
    __syncthreads();
    if (warp == 0)
      carry = composite_scan(t0, t1, S, zr, [&](int i) { return rb.tzs[i - t0]; }, carry,
                             rb.scan, [&](int i, float alpha, float tr) {
                               rb.twgt[i - t0] = alpha * tr;
                             });
    __syncthreads();
    for (int wp = warp; wp < WARPS; wp += WARP_STEP)
      warp_accumulate<T>(tw.d, rb, wp, t0 + wp * WR, S, rb.twgt + wp * WR, zr);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    float acc = 0.f;
    for (int wp = 0; wp < WARPS; ++wp) acc += rb.part[wp * P + c];
    rb.tot[c] = acc;
  }
  __syncthreads();
  // the head on the weighted sums: f32 accumulation, as per sample
  const T* rw = tw.w + tw.L.rgb_w;
  const float* rbias = tw.b + tw.L.rgb_b;
  float* o = out + (size_t)blockIdx.x * (C + 2);
  for (int c = threadIdx.x; c < C + 2; c += blockDim.x) {
    if (c >= C) {
      o[c] = rb.tot[H + c - C];
      continue;
    }
    float acc = 0.f;
    for (int q = 0; q < H; ++q) acc = fmaf(rb.tot[q], to_f<T>(rw[q * C + c]), acc);
    o[c] = fmaf(rb.tot[H + 1], rbias[c], acc);
  }
}

// g (R, C + 2) f32 cotangent of the forward output; writes dx, ddirs:
// d_emb (R*S, E), d_embd (R*S, Ed) in T or, RAW, d_pts and d_dirs
// (R*S, 3) f32; and d_z (R, S) f32. Stop-gradient rule: only the rgb
// channels, depth and acc feed the cotangent of the composite weights;
// the features reach only the head. GLOBAL: the per-sample state lies in
// scratch, R slices of state_bytes, one a ray (past what shared memory
// holds); else in shared memory, where the compiler then knows it is.
template <typename T, bool RAW, bool GLOBAL>
__global__ void __launch_bounds__(NT, 1)
render_bwd_kernel(Tower<T> tw, int S, const void* __restrict__ x, const void* __restrict__ dirs,
                  const float* __restrict__ z, const float* __restrict__ g,
                  void* __restrict__ dx, void* __restrict__ ddirs, float* __restrict__ d_z,
                  char* __restrict__ scratch) {
  extern __shared__ __align__(16) char nefes_smem[];
  RayBufs rb;
  carve_block(tw.d, tw.L, sizeof(T), true, GLOBAL ? 0 : S, nefes_smem, &rb);
  if (GLOBAL) carve_state(tw.d, S, scratch + blockIdx.x * state_bytes(tw.d, S), 0, &rb);
  const int C = 3 + tw.d.F, tiles = (S + BT - 1) / BT, warp = threadIdx.x >> 5;
  const size_t sample0 = (size_t)blockIdx.x * S;
  Stager<T> st(tw, rb, tiles, true);
  for (int i = threadIdx.x; i < S; i += blockDim.x) rb.z[i] = z[sample0 + i];
  for (int c = threadIdx.x; c < C + 2; c += blockDim.x) rb.gr[c] = g[blockIdx.x * (C + 2) + c];

  for (int t = 0; t < tiles; ++t)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP) {
      const int s0 = t * BT + wp * WR;
      warp_forward<T, RAW, KEEP_RENDER>(tw, rb, st, wp, s0, S, sample0, x, dirs, rb.zs + s0);
    }
  __syncthreads();
  if (warp == 0) ray_composite(rb, S, C, d_z + sample0);
  __syncthreads();
  // pass 2: the rgb/feature head's cotangent of sample r is w_r g, rounded
  for (int t = 0; t < tiles; ++t)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP) {
      const int s0 = t * BT + wp * WR, vr = S - s0 < WR ? S - s0 : WR;
      const float* wgt = rb.wgt + s0;
      const float* gr = rb.gr;
      warp_backward<T, RAW>(tw, rb, st, wp, s0, S, sample0, x, dirs, dx, ddirs, rb.dzs + s0,
                            [=](int r, int c) {
                              return (r < vr && c < C) ? rnd<T>(wgt[r] * gr[c]) : 0.f;
                            });
    }
}

// Shared-memory bytes of one block of the forward (bwd false) or of the
// backward at S samples a ray, in a pack dtype of ts bytes.
inline size_t block_smem(const Dims& d, int ts, bool bwd, int S) {
  const Layout L = make_layout(d);
  return carve_block(d, L, ts, bwd, bwd && state_in_smem(d, L, ts, S) ? S : 0, nullptr, nullptr);
}

// Bytes of global scratch one ray of the backward takes at S samples: 0
// while its per-sample state fits in shared memory.
inline size_t scratch_bytes(const Dims& d, int ts, int S) {
  return state_in_smem(d, make_layout(d), ts, S) ? 0 : state_bytes(d, S);
}

template <typename T, bool RAW>
int launch_fwd(int R, int S, const void* x, const void* dirs, const float* z, const void* w,
               const float* b, Dims d, float* out, void* stream) {
  const size_t smem = block_smem(d, sizeof(T), false, S);
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
               float* d_z, void* scratch, void* stream) {
  const bool global = scratch_bytes(d, sizeof(T), S) > 0;
  if (global && scratch == nullptr) return -2;   // the state needs the caller's scratch
  const size_t smem = block_smem(d, sizeof(T), true, S);
  auto* kern = global ? &render_bwd_kernel<T, RAW, true> : &render_bwd_kernel<T, RAW, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  NEFES_LAUNCH(kern, R, smem, stream, make_tower<T>(w, wt, b, d), S, x, dirs, z, g, dx, ddirs,
               d_z, static_cast<char*>(scratch));
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
               void* ddirs, float* d_z, void* scratch, void* stream) {
  if (R <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  return dtype == 1 ? launch_bwd<__nv_bfloat16, RAW>(R, S, x, dirs, z, w, wt, b, d, g, dx,
                                                     ddirs, d_z, scratch, stream)
                    : launch_bwd<float, RAW>(R, S, x, dirs, z, w, wt, b, d, g, dx, ddirs, d_z,
                                             scratch, stream);
}

#ifndef NEFES_EMULATE
// Blocks of the forward or the backward one SM holds at S samples a ray,
// from the occupancy calculator; -1 on an error.
template <typename T, bool RAW>
int blocks_per_sm(const Dims& d, bool backward, int S) {
  const size_t smem = block_smem(d, sizeof(T), backward, S);
  auto blocks = [&](auto kern) {
    int n = -1;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem) != cudaSuccess)
      return -1;
    return n;
  };
  if (!backward) return blocks(&render_fwd_kernel<T, RAW>);
  return scratch_bytes(d, sizeof(T), S) ? blocks(&render_bwd_kernel<T, RAW, true>)
                                        : blocks(&render_bwd_kernel<T, RAW, false>);
}
#endif

}  // namespace nefes

using nefes::Dims;

// dtype: 0 = float32, 1 = bfloat16 (pack dtype of weights, embeddings and
// embedding cotangents); z, out, g and d_z are float32. The backward's
// scratch: nefes_render_bwd_scratch_bytes(dtype, S, ...) bytes a ray, on
// the card, or null where that is 0.
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
                                    float* d_z, void* scratch, void* stream) {
  return nefes::render_bwd<false>(dtype, R, S, emb, embd, z, w, wt, b,
                                  Dims{depth, width, skipmask, E, Ed, F}, g, d_emb, d_embd, d_z,
                                  scratch, stream);
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
                                    float* d_pts, float* d_dirs, float* d_z, void* scratch,
                                    void* stream) {
  return nefes::render_bwd<true>(dtype, R, S, pts, dirs, z, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, g, d_pts, d_dirs, d_z,
                                 scratch, stream);
}

// Shared-memory bytes one block of each kernel asks for at S samples a
// ray; dtype as above (the forward's do not depend on S).
extern "C" int nefes_render_smem_bytes(int dtype, int backward, int S, int depth, int width,
                                       int skipmask, int E, int Ed, int F) {
  return (int)nefes::block_smem(Dims{depth, width, skipmask, E, Ed, F}, dtype == 1 ? 2 : 4,
                                backward, S);
}

// Bytes of global scratch the backward takes per ray at S samples: 0
// while a block keeps the per-sample state in shared memory.
extern "C" int nefes_render_bwd_scratch_bytes(int dtype, int S, int depth, int width,
                                              int skipmask, int E, int Ed, int F) {
  return (int)nefes::scratch_bytes(Dims{depth, width, skipmask, E, Ed, F}, dtype == 1 ? 2 : 4,
                                   S);
}

// Blocks of the forward or the backward (K3/K4, or raw K7/K8) one SM holds
// at S samples a ray, from the occupancy calculator; -1 on an error.
extern "C" int nefes_render_blocks_per_sm(int dtype, int backward, int raw, int S, int depth,
                                          int width, int skipmask, int E, int Ed, int F) {
#ifdef NEFES_EMULATE
  return 1;
#else
  using nefes::blocks_per_sm;
  using bf16 = __nv_bfloat16;
  const Dims d{depth, width, skipmask, E, Ed, F};
  if (dtype == 1)
    return raw ? blocks_per_sm<bf16, true>(d, backward, S)
               : blocks_per_sm<bf16, false>(d, backward, S);
  return raw ? blocks_per_sm<float, true>(d, backward, S)
             : blocks_per_sm<float, false>(d, backward, S);
#endif
}
