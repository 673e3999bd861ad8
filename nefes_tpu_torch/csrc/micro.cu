// The probe's micro-benchmark kernels on Hopper: the ablations that split
// the fused field's time into its parts (runtime/probe.py kernelmicro).
//
// K9 (chain) replaces run_chain / chain_kernel (runtime/probe.py:1252-1279):
// 8 layers h = relu(bf16(h @ W_i)) with f32 accumulation, the first 64 ->
// 128, then 128 -> 128. K10 (chain, nb > 1) replaces run_chain_interleaved
// (:1281-1312): the same chain over nb independent sub-tiles, every
// sub-tile's layer-i products issued before any layer i+1; its values are
// K9's. K11 (embed) replaces the embed-only kernel (:1328-1352): the
// probe's band-major layout, not the production embedder's. K12 (chain, E
// == W) replaces make_sq / chain_sq_kernel (:1361-1387): 8 square layers
// of width 128 or 256.
//
// A block takes `tile` rows and walks them in sub-tiles of TR = 64 rows
// (nb of them at once for K10), so the tile sweep keeps the probe's
// question: what does each grid step cost besides its products? The
// products reuse the tower's machinery (tower.cuh block_mm: mma.sync
// m16n8k16 on the tensor cores for bf16, f32 accumulation; FMA for f32),
// the activations live in shared memory in the element type (two buffers
// of TR x max(E, W) per sub-tile), and the weights are read through L1 as
// in the tower: K9's 240 KB of bf16 weights do not fit a block's 227 KB
// of shared memory. Bound on an H100: K9, K10 and K12 by operations (about
// 0.25 MFLOP per row for K9, 2 x 8 x W^2 per row for K12, against a few
// hundred bytes a row); K11 by bytes (12 in, 128 out per row, and 60
// sin/cos). K11's phases reach 512 |x|, hundreds of radians, so it takes
// the exact f32 phases x * 2^k and the full-precision sinf/cosf, whose
// argument reduction holds there (the __sinf intrinsic does not).
//
// The kernels are templated on the element type: the probe runs bf16; the
// f32 instantiation lets the host build (NEFES_EMULATE) check the
// indexing without a card.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "tower.cuh"

namespace nefes {

constexpr int EMBED_BANDS = 10;   // 2^0 .. 2^9
constexpr int EMBED_COLS = 64;    // 30 sines, 30 cosines, 4 zero columns

// Shared memory of one chain block: nb sub-tiles x two activation buffers
// of TR x max(E, W) elements of T (above 232448 bytes the launch fails on
// an H100).
template <typename T>
inline size_t chain_smem(int nb, int E, int W) {
  return (size_t)nb * 2 * TR * (E > W ? E : W) * sizeof(T);
}

// x (n, E) and out (n, W) in T; w: the D matrices, (E, W) then (W, W)
// (in, out) row-major, one after another. Block b takes rows [b * tile,
// (b + 1) * tile), nb sub-tiles of TR rows at a time.
template <typename T>
__global__ void __launch_bounds__(NT)
chain_kernel(int tile, int nb, int E, int W, int D, const T* __restrict__ x,
             const T* __restrict__ w, T* __restrict__ out) {
  extern __shared__ __align__(16) char nefes_smem[];
  T* buf = reinterpret_cast<T*>(nefes_smem);
  const size_t slot = (size_t)TR * (E > W ? E : W);
  const size_t row_blk = (size_t)blockIdx.x * tile;
  for (int g = 0; g < tile; g += nb * TR) {
    for (int s = 0; s < nb; ++s) {
      const T* src = x + (row_blk + g + s * TR) * E;
      T* dst = buf + 2 * s * slot;
      for (int i = threadIdx.x; i < TR * E; i += blockDim.x) dst[i] = src[i];
    }
    __syncthreads();
    const T* wl = w;
    for (int l = 0; l < D; ++l) {
      const int K = l ? W : E;
      for (int s = 0; s < nb; ++s) {
        const T* a = buf + (2 * s + (l & 1)) * slot;
        T* o = buf + (2 * s + 1 - (l & 1)) * slot;
        block_mm<T>(K, W, wl, W, [=](int r, int k) { return to_f<T>(a[r * K + k]); },
                    [=](int r, int c, float acc) { o[r * W + c] = from_f<T>(fmaxf(acc, 0.f)); });
      }
      wl += (size_t)K * W;
      __syncthreads();
    }
    for (int s = 0; s < nb; ++s) {
      const T* src = buf + (2 * s + (D & 1)) * slot;
      T* dst = out + (row_blk + g + s * TR) * W;
      for (int i = threadIdx.x; i < TR * W; i += blockDim.x) dst[i] = src[i];
    }
    __syncthreads();
  }
}

// pts (n, 3) f32 -> out (n, 64) in T: [sin(xs), cos(xs), 0 x 4] with xs =
// [x * 2^0, x * 2^1, ..., x * 2^9] band-major (column 3 k + j holds
// coordinate j of band k). Block b takes rows [b * tile, (b + 1) * tile).
template <typename T>
__global__ void __launch_bounds__(NT)
embed_kernel(int tile, const float* __restrict__ pts, T* __restrict__ out) {
  const size_t row0 = (size_t)blockIdx.x * tile;
  const int nx = 3 * EMBED_BANDS;
  for (int i = threadIdx.x; i < tile * EMBED_COLS; i += blockDim.x) {
    const int r = i / EMBED_COLS, c = i - r * EMBED_COLS;
    float v = 0.f;
    if (c < 2 * nx) {
      const int j = c < nx ? c : c - nx;
      const float ph = ldexpf(pts[(row0 + r) * 3 + j % 3], j / 3);
      v = c < nx ? sinf(ph) : cosf(ph);
    }
    out[(row0 + r) * EMBED_COLS + c] = from_f<T>(v);
  }
}

template <typename T>
int launch_chain(int n, int tile, int nb, int E, int W, int D, const void* x, const void* w,
                 void* out, void* stream) {
  const size_t smem = chain_smem<T>(nb, E, W);
  auto* kern = &chain_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  NEFES_LAUNCH(kern, n / tile, smem, stream, tile, nb, E, W, D, static_cast<const T*>(x),
               static_cast<const T*>(w), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_embed(int n, int tile, const float* pts, void* out, void* stream) {
  auto* kern = &embed_kernel<T>;
  NEFES_LAUNCH(kern, n / tile, 0, stream, tile, pts, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace nefes

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). nb: sub-tiles issued
// together (1: K9 and K12, 2 or 4: K10). n must be a multiple of tile and
// tile of nb x 64; -1 for bf16 in the host build, -4 for such a shape.
extern "C" int nefes_micro_chain(int dtype, int n, int tile, int nb, int E, int W, int D,
                                 const void* x, const void* w, void* out, void* stream) {
  if (dtype == 1 && !nefes::HAS_BF16) return -1;
  if (nb < 1 || E < 1 || W < 1 || D < 1) return -4;
  if (n < 1 || tile < 1 || tile % (nb * nefes::TR) || n % tile) return -4;
  return dtype == 1
             ? nefes::launch_chain<__nv_bfloat16>(n, tile, nb, E, W, D, x, w, out, stream)
             : nefes::launch_chain<float>(n, tile, nb, E, W, D, x, w, out, stream);
}

// pts (n, 3) f32 -> out (n, 64) in dtype; n a multiple of tile.
extern "C" int nefes_micro_embed(int dtype, int n, int tile, const float* pts, void* out,
                                 void* stream) {
  if (dtype == 1 && !nefes::HAS_BF16) return -1;
  if (n < 1 || tile < 1 || n % tile) return -4;
  return dtype == 1 ? nefes::launch_embed<__nv_bfloat16>(n, tile, pts, out, stream)
                    : nefes::launch_embed<float>(n, tile, pts, out, stream);
}
