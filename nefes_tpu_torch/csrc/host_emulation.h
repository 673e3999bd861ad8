// Host emulation of the few CUDA features the kernels of this directory
// use, so that their sources build with a C++ compiler (-DNEFES_EMULATE)
// and run on the CPU: every block runs on one thread, in order, and
// __syncthreads() is a no-op. This checks the arithmetic, the rounding
// points and the indexing against the plain PyTorch versions without a
// card; it cannot show races or anything about speed.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

struct NefesDim3 {
  unsigned x, y, z;
};

namespace nefes_emu {
inline NefesDim3 thread_idx{0, 0, 0};
inline NefesDim3 block_idx{0, 0, 0};
inline NefesDim3 block_dim{1, 1, 1};
inline NefesDim3 grid_dim{1, 1, 1};
}  // namespace nefes_emu

#define threadIdx nefes_emu::thread_idx
#define blockIdx nefes_emu::block_idx
#define blockDim nefes_emu::block_dim
#define gridDim nefes_emu::grid_dim

inline void __syncthreads() {}

struct __nv_bfloat16 {
  uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40u)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);   // round to nearest, ties to even
  return {(uint16_t)(u >> 16)};
}

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
enum NefesFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, NefesFuncAttribute, int bytes) {
  return bytes <= (1 << 18) ? cudaSuccess : 1;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace nefes {
alignas(16) char nefes_smem[1 << 18];
}

#define NEFES_LAUNCH(kern, grid, smem, stream, ...)                          \
  nefes_emu::grid_dim.x = (unsigned)(grid);                                 \
  for (unsigned nefes_b = 0; nefes_b < (unsigned)(grid); ++nefes_b) {       \
    nefes_emu::block_idx.x = nefes_b;                                       \
    kern(__VA_ARGS__);                                                      \
  }
