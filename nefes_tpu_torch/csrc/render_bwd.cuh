// The warp path of the tower kernels: per-warp tiles of 16 samples, bf16
// activations in shared memory, products on the tensor cores with
// mma.sync fed by ldmatrix, the tower's weights staged matrix by matrix
// into shared memory by cp.async, double-buffered, and the volume
// composite (and its backward) as warp scans. Two sources include this
// header: fused_render.cu (K3 render_fwd_pre, K4 render_bwd_pre, K7
// render_fwd, K8 render_bwd) and fused_field.cu, whose forward K1/K5 runs
// warp_forward in sigma, full and transient mode (field_warp_kernel) and
// whose backward K2/K6 in sigma and full mode runs warp_forward and then
// warp_backward per warp, with or without the dW operands
// (field_bwd_warp_kernel; transient mode stays on tower.cuh).
//
// A block renders one ray in block tiles of BT = 128 samples: warp w owns
// the tile's rows [16 w, 16 w + 16) through every layer, so the layers
// need no barrier between warps; the only block barrier of a product is
// the stage's (every warp reads the same staged matrix). warp_forward runs
// a warp's rows to the sigma head and (DIR) on to the dir layer; the
// backward (KEEP) also keeps, per sample, what the frozen backward reads:
// the ReLU bits of each hidden layer and of the dir layer, the sigma
// pre-activation and (the render backward) the three rgb values. The
// forward kernel streams the composite tile by tile and keeps nothing per
// sample past its tile. The backward runs
// warp_forward over the whole ray, warp 0 then runs the composite and its
// backward, and pass 2 runs only the backward from the kept state: no
// forward is recomputed. That state stays in shared memory while it fits
// beside the stages and warp tiles (at D8/W128: 269 samples in bf16, 204
// in f32); past that the block keeps it in its slice of a global scratch
// that the caller allocates (state_bytes a ray).
//
// Products (bf16): out(16 x N) = A(16 x K) B(K x N) per warp, in chunks of
// 64 columns, m16n8k16 with f32 accumulators. A comes from shared memory
// by ldmatrix.x4 (or, for the rgb head's cotangent w_r g_c, is built in
// registers); B from the staged matrix by ldmatrix.x4.trans when it is
// stored (K, N), by ldmatrix.x4 when (N, K). Every buffer has a row stride
// of pad16(cols) + 8 elements, an odd number of 16-byte units, so the
// eight rows of an ldmatrix phase fall in eight distinct bank groups. The
// stage copies each matrix from whichever blob has 16-byte aligned rows
// (w, (in, out), for the forward and for the backward products whose
// output is an embedding; wt, (out, in), for the others), zero-padding
// rows and columns to multiples of 16. f32 runs the same structure with
// f32 activations on the CUDA cores, reading the weights from global
// memory (the parity mode; the host build checks it on the CPU).
//
// Same function and rounding points as tower.cuh's tower_forward /
// tower_backward in SIGMA and FULL mode (and fused_render.py's and
// fused_field.py's plain versions): hidden layers accumulate in f32 and
// round to T before the bias and ReLU in T; heads accumulate in f32. With
// dW (the field backward) a warp writes its rows' dW operands in
// tower.cuh's DwSlot layout (WarpDw).
//
// Host emulation (NEFES_EMULATE): a block is one thread, so a "warp" is
// one thread looping over its 32 lanes (LANES = 1) and the block loops
// over its warps (WARP_STEP = 1); the warp scans run in the same order.

#pragma once

#include "tower.cuh"

namespace nefes {

constexpr int WR = 16;             // rows per warp
constexpr int WARPS = NT / 32;     // warps per block
constexpr int BT = WR * WARPS;     // samples per block tile
#ifdef NEFES_EMULATE
constexpr int LANES = 1, WARP_STEP = 1;
__device__ inline void __syncwarp() {}
#else
constexpr int LANES = 32, WARP_STEP = WARPS;
#endif

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
// row stride, in elements, of every buffer the products read
__host__ __device__ constexpr int ld_of(int cols) { return pad16(cols) + 8; }

// The bf16 instantiation on the card stages its weights; f32 (and the
// host build) reads them from global memory.
template <typename T>
constexpr bool kStaged = HAS_BF16 && std::is_same<T, __nv_bfloat16>::value;

// The forward sequences a block stages, each in the order its products
// read the matrices: to the sigma head (the field forward's sigma mode),
// to the dir layer (the render kernels), to the rgb/feature head (the
// field forward's full mode), and on through the NeRF-W transient branch
// (the field forward's transient mode). They share their prefix, mat_at's
// forward.
enum Seq { SEQ_SIGMA, SEQ_DIR, SEQ_HEADS, SEQ_TRANSIENT };

// One matrix of the packed blobs as a product reads it: rows x cols,
// row-major at offset `off` of w (or wt); nk: stored (N, K) rather than
// (K, N).
struct MatDesc {
  int off, rows, cols;
  bool wt, nk;
};

// The k-th matrix the forward (bwd = false) or the backward reads, in the
// order they are used; off = -1 past the last. The backward's products
// with an embedding as output read w, (E, W) / (Ed, H) as (N, K): wt's
// rows of E or Ed values are not 16-byte aligned.
__host__ __device__ inline MatDesc mat_at(const Dims& d, const Layout& L, bool bwd, int k) {
  const int W = d.width, H = W / 2, C = 3 + d.F;
  int n = 0;
  if (!bwd) {
    if (k == n++) return {L.we[0], d.E, W, false, false};
    for (int i = 1; i < d.depth; ++i) {
      if (k == n++) return {L.wh[i], W, W, false, false};
      if (((d.skipmask >> i) & 1) && k == n++) return {L.we[i], d.E, W, false, false};
    }
    if (k == n++) return {L.fin_w, W, W, false, false};
    if (k == n++) return {L.dir_wh, W, H, false, false};
    if (k == n++) return {L.dir_wd, d.Ed, H, false, false};
  } else {
    if (k == n++) return {L.rgb_w, C, H, true, false};
    if (k == n++) return {L.dir_wh, H, W, true, false};
    if (k == n++) return {L.dir_wd, d.Ed, H, false, true};
    if (k == n++) return {L.fin_w, W, W, true, false};
    for (int i = d.depth - 1; i >= 1; --i) {
      if (k == n++) return {L.wh[i], W, W, true, false};
      if (((d.skipmask >> i) & 1) && k == n++) return {L.we[i], d.E, W, false, true};
    }
    if (k == n++) return {L.we[0], d.E, W, false, true};
  }
  return {-1, 0, 0, false, false};
}

__host__ __device__ inline int mat_count(const Dims& d, const Layout& L, bool bwd) {
  int n = 0;
  while (mat_at(d, L, bwd, n).off >= 0) ++n;
  return n;
}

// The k-th matrix of forward sequence FWD (off = -1 past the last): the
// hidden layers as mat_at's forward lists them, then (SEQ_HEADS and
// SEQ_TRANSIENT) final, the dir layer's two and the rgb/feature head,
// which reads wt, (C, H) as (N, K), since w's rows of C values are not
// 16-byte aligned; then (SEQ_TRANSIENT) t1's two, t2 and t3 from w, and
// the five transient head columns as one (5, H) matrix read as (N, K):
// wt holds ts_w (1, H), tr_w (3, H) and tb_w (1, H) back to back from
// ts_w's offset. Listed, not counted from mat_at: the stager calls it for
// every matrix it copies.
template <Seq FWD>
__host__ __device__ inline MatDesc fwd_mat(const Dims& d, const Layout& L, int k) {
  if constexpr (FWD == SEQ_DIR) {
    return mat_at(d, L, false, k);
  } else {
    const int W = d.width, H = W / 2;
    int n = 0;
    if (k == n++) return {L.we[0], d.E, W, false, false};
    for (int i = 1; i < d.depth; ++i) {
      if (k == n++) return {L.wh[i], W, W, false, false};
      if (((d.skipmask >> i) & 1) && k == n++) return {L.we[i], d.E, W, false, false};
    }
    if (FWD != SEQ_SIGMA) {
      if (k == n++) return {L.fin_w, W, W, false, false};
      if (k == n++) return {L.dir_wh, W, H, false, false};
      if (k == n++) return {L.dir_wd, d.Ed, H, false, false};
      if (k == n++) return {L.rgb_w, 3 + d.F, H, true, true};
    }
    if (FWD == SEQ_TRANSIENT) {
      if (k == n++) return {L.t1_wh, W, H, false, false};
      if (k == n++) return {L.t1_wd, d.Ed, H, false, false};
      if (k == n++) return {L.t2_w, H, H, false, false};
      if (k == n++) return {L.t3_w, H, H, false, false};
      if (k == n++) return {L.ts_w, 5, H, true, true};
    }
    return {-1, 0, 0, false, false};
  }
}

template <Seq FWD>
__host__ __device__ inline int fwd_count(const Dims& d, const Layout& L) {
  int n = 0;
  while (fwd_mat<FWD>(d, L, n).off >= 0) ++n;
  return n;
}

// How a block's stager orders its matrices: the forward sequence of every
// block tile, then the backward's of every tile (ORD_RAY, the render
// backward), or each tile's forward and then its backward (ORD_TILE, the
// field backward in full mode; ORD_TILE_SIGMA in sigma mode, whose
// backward starts at the last hidden layer: mat_at's backward from
// BWD_HEADS on, without the rgb head, the dir layer and final).
enum Order { ORD_RAY, ORD_TILE, ORD_TILE_SIGMA };
constexpr int BWD_HEADS = 4;

template <Order ORD>
__host__ __device__ constexpr int bwd_first() {
  return ORD == ORD_TILE_SIGMA ? BWD_HEADS : 0;
}

// elements of one staged matrix
__host__ __device__ inline int staged_elems(const MatDesc& m) {
  return pad16(m.rows) * ld_of(m.cols);
}

// A matrix as a product reads it: p[k * ld + n] ((K, N)) or p[n * ld + k]
// ((N, K)), in shared memory when staged, else in global memory.
template <typename T>
struct Mat {
  const T* p;
  int ld;
  bool nk;
};

// Shared memory of one block of a render kernel or of the field forward
// (and, for the render backward past the budget, its slice of the global
// scratch).
struct RayBufs {
  char* wbuf[2];    // the two weight stages (staged only)
  char* warps;      // WARPS per-warp regions of wbytes each
  size_t wbytes;
  float* scan;      // 32 the composite's scan
  // the backward's
  float* gr;        // C + 2 the ray's output cotangent
  uint32_t* mask;   // S x mw: ReLU bits of every hidden layer, then the dir layer's
  int mw;
  float* zs;        // S sigma pre-activation
  float* rgb;       // S x 3
  float* z;         // S
  float* wgt;       // S composite weights
  float* trans;     // S transmittance
  float* dzs;       // S cotangent of zs
  float* dd;        // S cotangent of delta
  // the forward's (the field forward's: tzs only)
  float* tzs;       // BT the tile's sigma pre-activations
  float* twgt;      // BT the tile's composite weights
  float* part;      // WARPS x (H + 2) per-warp sums of w de, w z and w
  float* tot;       // H + 2 their sum over the warps
};

// Bytes of one warp's region and the offsets of its buffers: xe (the
// embedding, then the rgb head's cotangent dzd, then d_emb in f32), xd (the
// dir embedding, then d_embd in f32), ha, hb (hidden layers, cotangents).
// lean: the field forward's region, only what warp_forward reads (xe the
// embedding, xd the dir embedding only with dirs). Every caller passes
// lean and dirs as constants, so the offsets fold into the code.
struct WarpLayout {
  size_t xe, xd, h, total;
};

__host__ __device__ inline WarpLayout warp_layout(const Dims& d, int ts, bool lean = false,
                                                  bool dirs = true) {
  auto mx = [](size_t a, size_t b) { return a > b ? a : b; };
  const int H = d.width / 2;
  WarpLayout w;
  w.xe = WR * (lean ? (size_t)ld_of(d.E) * ts
                    : mx(mx(ld_of(d.E), ld_of(H)) * (size_t)ts, (size_t)d.E * 4));
  w.xd = !dirs ? 0 : WR * (lean ? (size_t)ld_of(d.Ed) * ts
                                : mx((size_t)ld_of(d.Ed) * ts, (size_t)d.Ed * 4));
  w.h = (size_t)WR * ld_of(d.width) * ts;
  w.xe = (w.xe + 15) / 16 * 16;
  w.xd = (w.xd + 15) / 16 * 16;
  w.total = w.xe + w.xd + 2 * w.h;
  return w;
}

// The backward's per-sample state of S samples, carved from base at
// offset off; returns the offset past it.
__host__ __device__ inline size_t carve_state(const Dims& d, int S, char* base, size_t off,
                                              RayBufs* t) {
  t->mw = d.depth * ((d.width + 31) / 32) + (d.width / 2 + 31) / 32;
  t->mask = reinterpret_cast<uint32_t*>(take(base, &off, (size_t)S * t->mw));
  t->zs = take(base, &off, S);
  t->rgb = take(base, &off, (size_t)S * 3);
  t->z = take(base, &off, S);
  t->wgt = take(base, &off, S);
  t->trans = take(base, &off, S);
  t->dzs = take(base, &off, S);
  t->dd = take(base, &off, S);
  return off;
}

// Bytes of the backward's per-sample state of one ray of S samples.
__host__ __device__ inline size_t state_bytes(const Dims& d, int S) {
  RayBufs t;
  return carve_state(d, S, nullptr, 0, &t);
}

// Carve one block's shared memory for the forward (bwd false) or the
// backward, whose per-sample state of S_smem samples follows in shared
// memory (0: the state lies in the global scratch). ts: bytes of the pack
// dtype; a 2-byte pack stages its weights. Returns the bytes used; base
// == nullptr: size only (host side).
__host__ __device__ inline size_t carve_block(const Dims& d, const Layout& L, int ts, bool bwd,
                                              int S_smem, char* base, RayBufs* rb) {
  RayBufs t{};
  size_t off = 0;
  auto bytes = [&](size_t n) {
    char* p = base ? base + off : nullptr;
    off += (n + 15) / 16 * 16;
    return p;
  };
  size_t stage = 0;
  if (ts == 2) {
    for (int b = 0; b <= (bwd ? 1 : 0); ++b)
      for (int k = 0; mat_at(d, L, b, k).off >= 0; ++k) {
        const size_t e = staged_elems(mat_at(d, L, b, k));
        stage = stage > e ? stage : e;
      }
  }
  t.wbuf[0] = bytes(stage * ts);
  t.wbuf[1] = bytes(stage * ts);
  t.wbytes = warp_layout(d, ts).total;
  t.warps = bytes(WARPS * t.wbytes);
  t.scan = take(base, &off, 32);
  if (bwd) {
    t.gr = take(base, &off, 3 + d.F + 2);
    if (S_smem > 0) off = carve_state(d, S_smem, base, off, &t);
  } else {
    const int P = d.width / 2 + 2;
    t.tzs = take(base, &off, BT);
    t.twgt = take(base, &off, BT);
    t.part = take(base, &off, (size_t)WARPS * P);
    t.tot = take(base, &off, P);
  }
  if (rb) *rb = t;
  return off;
}

// A block's shared memory on an H100 (and the most one may ask for)
constexpr size_t SMEM_MAX = 232448;

// Whether the backward's block keeps the per-sample state of its S
// samples in shared memory (else in the global scratch).
__host__ __device__ inline bool state_in_smem(const Dims& d, const Layout& L, int ts, int S) {
  return carve_block(d, L, ts, true, S, nullptr, nullptr) <= SMEM_MAX;
}

// ---- the card's primitives (no-ops in the host build, which never stages)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#ifdef NEFES_EMULATE
  return 0;
#else
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#endif
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifndef NEFES_EMULATE
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifndef NEFES_EMULATE
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifndef NEFES_EMULATE
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Copy matrix m of blob src into a stage: rows padded to pad16(rows),
// columns to pad16(cols) with zeros, row stride ld_of(cols). 16-byte
// aligned chunks go by cp.async, the rest (and the padding) by plain
// stores; the caller commits and waits.
template <typename T>
__device__ void stage_copy(const MatDesc& m, const T* __restrict__ src, T* dst) {
  const int units = pad16(m.cols) / 8, ld = ld_of(m.cols);
  const T zero = from_f<T>(0.f);
  for (int u = threadIdx.x; u < pad16(m.rows) * units; u += blockDim.x) {
    const int r = u / units, c0 = (u - r * units) * 8;
    T* d = dst + r * ld + c0;
    const T* s = src + (size_t)r * m.cols + c0;
    if (r < m.rows && c0 + 8 <= m.cols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
      for (int j = 0; j < 8; ++j) d[j] = (r < m.rows && c0 + j < m.cols) ? s[j] : zero;
    }
  }
}

// The weight pipeline of one block: every thread calls get() for every
// product in the same order, so g counts the matrices of the whole kernel
// (the forward's sequence FWD per block tile of the block and, in a
// backward, the backward's per block tile, in the order ORD; the copy of
// a block tile's first matrix overlaps the previous tile's last
// product). get() waits for matrix g, makes it visible to the block (the
// barrier also means every warp is done with matrix g - 1), starts the
// copy of matrix g + 1 into the other stage and returns matrix g; the
// copy overlaps g's products. Unstaged, get() hands out the global
// matrix. The tower is an argument of each call, not a member, and the
// stage is picked by a select, not an index: either would put the
// kernel's parameters or the two stage pointers in local memory.
template <typename T, Seq FWD = SEQ_DIR, Order ORD = ORD_RAY>
struct Stager {
  T* buf0;
  T* buf1;
  int tiles, n_fwd, n_bwd, g;

  __device__ Stager(const Tower<T>& tw, const RayBufs& rb, int tiles_, bool bwd)
      : buf0(reinterpret_cast<T*>(rb.wbuf[0])), buf1(reinterpret_cast<T*>(rb.wbuf[1])),
        tiles(tiles_), n_fwd(fwd_count<FWD>(tw.d, tw.L)),
        n_bwd(bwd ? mat_count(tw.d, tw.L, true) - bwd_first<ORD>() : 0), g(0) {
    if (kStaged<T>) fetch(tw, 0);
  }

  __device__ T* stage(int k) const { return (k & 1) ? buf1 : buf0; }

  __device__ void fetch(const Tower<T>& tw, int k) {
    if constexpr (ORD == ORD_RAY) {
      if (k < tiles * n_fwd)
        copy(tw, fwd_mat<FWD>(tw.d, tw.L, k % n_fwd), stage(k));
      else if (k < tiles * (n_fwd + n_bwd))
        copy(tw, mat_at(tw.d, tw.L, true, (k - tiles * n_fwd) % n_bwd), stage(k));
    } else if (k < tiles * (n_fwd + n_bwd)) {
      const int j = k % (n_fwd + n_bwd);
      copy(tw,
           j < n_fwd ? fwd_mat<FWD>(tw.d, tw.L, j)
                     : mat_at(tw.d, tw.L, true, j - n_fwd + bwd_first<ORD>()),
           stage(k));
    }
    cp_async_commit();
  }

  __device__ void copy(const Tower<T>& tw, const MatDesc& m, T* dst) {
    stage_copy<T>(m, (m.wt ? tw.wt : tw.w) + m.off, dst);
  }

  __device__ Mat<T> get(const Tower<T>& tw, const MatDesc& m) {
    if constexpr (!kStaged<T>) {
      return {(m.wt ? tw.wt : tw.w) + m.off, m.cols, m.nk};
    } else {
      cp_async_wait_all();
      __syncthreads();
      fetch(tw, g + 1);
      return {stage(g++), ld_of(m.cols), m.nk};
    }
  }
};

// ---- warp products

// A operands: rows of a buffer in shared memory, or a function of (r, k).
template <typename T>
struct SmemA {
  const T* p;
  int ld;
  __device__ float operator()(int r, int k) const { return to_f<T>(p[r * ld + k]); }
};

template <typename Fn>
struct FnA {
  Fn fn;
  __device__ float operator()(int r, int k) const { return fn(r, k); }
};

#ifndef NEFES_EMULATE
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of m16n8k16 for k-step k0: lanes 0-15 address rows 0-15 at
// k0, lanes 16-31 the same rows at k0 + 8.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const SmemA<__nv_bfloat16>& A, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, A.p + (lane & 15) * A.ld + k0 + ((lane >> 4) << 3));
}

template <typename Fn>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const FnA<Fn>& A, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, k = k0 + 2 * (lane & 3);
  a[0] = pack_bf16x2(A(g, k), A(g, k + 1));
  a[1] = pack_bf16x2(A(g + 8, k), A(g + 8, k + 1));
  a[2] = pack_bf16x2(A(g, k + 8), A(g, k + 9));
  a[3] = pack_bf16x2(A(g + 8, k + 8), A(g + 8, k + 9));
}

// B fragments of two n-tiles (n0, n0 + 8) at k-step k0: b[0], b[1] for
// the first, b[2], b[3] for the second.
__device__ __forceinline__ void b_frag(uint32_t (&b)[4], const Mat<__nv_bfloat16>& B, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  if (B.nk)
    ldsm_x4(b, B.p + (n0 + (lane & 7) + ((lane >> 4) << 3)) * B.ld + k0 + (((lane >> 3) & 1) << 3));
  else
    ldsm_x4_t(b, B.p + (k0 + (lane & 15)) * B.ld + n0 + ((lane >> 4) << 3));
}

// One warp's out(16 x N) = A(16 x K) B, handed to epi(r, c, acc) for
// c < N. K is padded to 16 (A's and B's padding hold zeros), N to 16.
template <typename AS, typename Epi>
__device__ __forceinline__ void warp_mm_mma(const AS& A, int K, const Mat<__nv_bfloat16>& B,
                                            int N, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Kp = pad16(K), Np = pad16(N);
  __syncwarp();   // ldmatrix and mma.sync take the whole warp, converged
  for (int n0 = 0; n0 < Np; n0 += 64) {
    const int pairs = (Np - n0) >= 64 ? 4 : (Np - n0) >> 4;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      uint32_t a[4];
      a_frag(a, A, k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < pairs) {
          uint32_t b[4];
          b_frag(b, B, k0, n0 + 16 * j);
          mma_bf16(acc[2 * j], a, b[0], b[1]);
          mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (j < 2 * pairs) {
        if (c < N) { epi(g, c, acc[j][0]); epi(g + 8, c, acc[j][2]); }
        if (c + 1 < N) { epi(g, c + 1, acc[j][1]); epi(g + 8, c + 1, acc[j][3]); }
      }
    }
  }
}
#endif

// One warp's out(16 x N) = A(16 x K) B -> epi(r, c, acc). bf16 staged:
// the tensor cores; otherwise the CUDA cores, lane c % 32 owning column c
// (f32 sums in k order). Either way an element's lane depends only on
// (r, c), so two products with the same N hand it to the same lane.
template <typename T, typename AS, typename Epi>
__device__ __forceinline__ void warp_mm(const AS& A, int K, const Mat<T>& B, int N, Epi epi) {
#ifndef NEFES_EMULATE
  if constexpr (kStaged<T>) {
    warp_mm_mma(A, K, B, N, epi);
  } else
#endif
  {
    for (int c = threadIdx.x & (LANES - 1); c < N; c += LANES) {
      float acc[WR];
#pragma unroll
      for (int r = 0; r < WR; ++r) acc[r] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float b = to_f<T>(B.nk ? B.p[(size_t)c * B.ld + k] : B.p[(size_t)k * B.ld + c]);
#pragma unroll
        for (int r = 0; r < WR; ++r) acc[r] = fmaf(A(r, k), b, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < WR; ++r) epi(r, c, acc[r]);
    }
  }
}

// ---- per-warp tower

template <typename T>
struct WarpBufs {
  T* xe;
  T* xd;
  T* ha;
  T* hb;
};

template <typename T>
__device__ inline WarpBufs<T> warp_bufs(const Dims& d, const RayBufs& rb, int wp,
                                        bool lean = false, bool dirs = true) {
  const WarpLayout w = warp_layout(d, sizeof(T), lean, dirs);
  char* base = rb.warps + wp * rb.wbytes;
  return {reinterpret_cast<T*>(base), reinterpret_cast<T*>(base + w.xe),
          reinterpret_cast<T*>(base + w.xe + w.xd),
          reinterpret_cast<T*>(base + w.xe + w.xd + w.h)};
}

// The ReLU bits of a warp's output act (16 x n, row stride ld) for its
// first vr rows into bits (row stride mw words).
template <typename T>
__device__ inline void keep_bits(const T* act, int ld, int n, int vr, uint32_t* bits, int mw) {
  const int nw = (n + 31) / 32;
  for (int j = threadIdx.x & (LANES - 1); j < vr * nw; j += LANES) {
    const int r = j / nw, w = j - r * nw;
    const T* row = act + r * ld + w * 32;
    uint32_t b = 0;
    for (int t = 0; t < 32 && w * 32 + t < n; ++t) b |= (to_f<T>(row[t]) > 0.f ? 1u : 0u) << t;
    bits[r * mw + w] = b;
  }
}

// A warp's input rows [s, s + vr) into dst (16 x C, row stride ld, zero
// past vr rows and C columns): rows of the pre-embedded (N, C) array in T
// or, RAW, the embedding of the f32 (N, 3) points.
template <typename T, bool RAW>
__device__ inline void warp_rows_in(T* dst, int ld, const void* src, size_t s, int vr, int C) {
  const int Cp = pad16(C);
  for (int i = threadIdx.x & (LANES - 1); i < WR * Cp; i += LANES) {
    const int r = i / Cp, c = i - r * Cp;
    T v = from_f<T>(0.f);
    if (r < vr && c < C) {
      if (RAW)
        v = from_f<T>(embed_value(static_cast<const float*>(src) + (s + r) * 3, c));
      else
        v = static_cast<const T*>(src)[(s + r) * C + c];
    }
    dst[r * ld + c] = v;
  }
}

// Eight values of T from src to dst (both 16-byte aligned) by streaming
// stores (st.global.cs, tower.cuh's store8).
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
#ifndef NEFES_EMULATE
  if constexpr (sizeof(T) == 2) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(src));
  } else {
    __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
    __stcs(reinterpret_cast<float4*>(dst) + 1, *(reinterpret_cast<const float4*>(src) + 1));
  }
#else
  for (int j = 0; j < 8; ++j) dst[j] = src[j];
#endif
}

// Where one warp's rows write their dW operands (the field backward with
// dW; ON false: nowhere, every call a no-op): the chunk's buffer in
// tower.cuh's DwSlot layout, the block's slot table (dw_table), the
// chunk's rows, the warp's first row in the chunk and its valid rows. A
// slot's rows [0, vr) come from a warp buffer (buf: 16-byte rows, zero
// from the slot's columns to pad16, so eight values go at a time) or from
// a function of (r, c) (fn: rounded to T on the store); the padding
// columns are zero. No barrier: the caller's __syncwarp() orders them.
template <typename T, bool ON>
struct WarpDw {
  T* ops;
  const int* slots;
  int rows, row0, vr;

  __device__ T* slot(int k, int ld) const {
    return ops + (size_t)slots[N_SLOTS + k] * rows + (size_t)row0 * ld;
  }

  __device__ void buf(int k, const T* src, int lds) const {
    if constexpr (ON) {
      const int ld = pad8(slots[k]), units = ld / 8;
      T* dst = slot(k, ld);
      for (int u = threadIdx.x & (LANES - 1); u < vr * units; u += LANES) {
        const int r = u / units, c = (u - r * units) * 8;
        copy8(dst + (size_t)r * ld + c, src + r * lds + c);
      }
    }
  }

  template <typename Fn>
  __device__ void fn(int k, Fn f) const {
    if constexpr (ON) {
      const int cols = slots[k], ld = pad8(cols), units = ld / 8;
      T* dst = slot(k, ld);
      for (int u = threadIdx.x & (LANES - 1); u < vr * units; u += LANES) {
        const int r = u / units, c = (u - r * units) * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = c + j < cols ? f(r, c + j) : 0.f;
        store8(dst + (size_t)r * ld + c, v);
      }
    }
  }
};

// What warp_forward keeps for a backward: nothing (the forwards), the
// ReLU bits of every layer (the field backward) or also the three rgb
// values (the render backward, whose composite reads them).
enum Keep { KEEP_NONE, KEEP_BITS, KEEP_RENDER };

// The buffer of warp wp's region in which warp_forward leaves the dir
// layer's output de (16 x H, row stride ld_of(H)): the hidden layers
// alternate between ha and hb, and de overwrites the last one's input.
template <typename T>
__device__ inline const T* warp_de(const Dims& d, const RayBufs& rb, int wp, bool lean = false) {
  const WarpBufs<T> wb = warp_bufs<T>(d, rb, wp, lean);
  return (d.depth & 1) ? wb.hb : wb.ha;
}

// The forward of one warp over the ray's samples [s0, s0 + 16) (vr of
// them valid): the sigma pre-activations into zs[0, vr) and, DIR, the dir
// layer's output de left in warp_de(). Without DIR the warp stops after
// the sigma head and reads no dirs (the field's sigma mode); LEAN: the
// field forward's warp layout; st the block's stager. KEEP: also what a
// backward reads in rb (the ReLU bits at rb.mask + s0 rows, and for the
// render backward the rgb head). dw: the A operands of the dW products
// (the embeddings, every hidden layer, final and the dir layer's output).
// Both passes are inlined into the kernel: a call passes the tower, the
// stager and the epilogues through local memory, a stack frame that cost
// the bf16 K4 more than a third of its time on an H100.
template <typename T, bool RAW, Keep KEEP, bool DIR = true, bool LEAN = false, typename St,
          typename Dw = WarpDw<T, false>>
__device__ __forceinline__ void warp_forward(const Tower<T>& tw, const RayBufs& rb, St& st,
                                             int wp, int s0, int S, size_t sample0, const void* x,
                                             const void* dirs, float* zs, const Dw& dw = Dw{}) {
  const Dims& d = tw.d;
  const Layout& L = tw.L;
  const int W = d.width, H = W / 2, E = d.E, Ed = d.Ed, C = 3 + d.F, nw = (W + 31) / 32;
  const int ldw = ld_of(W), ldh = ld_of(H), lde = ld_of(E), ldd = ld_of(Ed);
  const int vr = S - s0 < 0 ? 0 : (S - s0 < WR ? S - s0 : WR);
  const WarpBufs<T> wb = warp_bufs<T>(d, rb, wp, LEAN, DIR);
  uint32_t* bits = KEEP != KEEP_NONE ? rb.mask + (size_t)s0 * rb.mw : nullptr;
  static_assert(DIR || KEEP != KEEP_RENDER, "the render backward's state needs the dir layer");
  warp_rows_in<T, RAW>(wb.xe, lde, x, sample0 + s0, vr, E);
  if (DIR) warp_rows_in<T, RAW>(wb.xd, ldd, dirs, sample0 + s0, vr, Ed);
  __syncwarp();
  dw.buf(A_EMB, wb.xe, lde);
  if (DIR) dw.buf(A_EMBD, wb.xd, ldd);

  const SmemA<T> a_emb{wb.xe, lde};
  T* h = wb.ha;
  T* hn = wb.hb;
  int k = 0;
  for (int i = 0; i < d.depth; ++i) {
    const float* bias = tw.b + L.b[i];
    T* ho = hn;
    auto bias_relu = [=](int r, int c, float z) {
      z = rnd<T>(z + rnd<T>(bias[c]));
      ho[r * ldw + c] = from_f<T>(fmaxf(z, 0.f));
    };
    const SmemA<T> a_h{h, ldw};
    if (i == 0) {
      warp_mm<T>(a_emb, E, st.get(tw, mat_at(d, L, false, k++)), W,
                 [=](int r, int c, float acc) { bias_relu(r, c, rnd<T>(acc)); });
    } else if ((d.skipmask >> i) & 1) {
      warp_mm<T>(a_h, W, st.get(tw, mat_at(d, L, false, k++)), W,
                 [=](int r, int c, float acc) { ho[r * ldw + c] = from_f<T>(acc); });
      warp_mm<T>(a_emb, E, st.get(tw, mat_at(d, L, false, k++)), W, [=](int r, int c, float acc) {
        bias_relu(r, c, rnd<T>(to_f<T>(ho[r * ldw + c]) + rnd<T>(acc)));
      });
    } else {
      warp_mm<T>(a_h, W, st.get(tw, mat_at(d, L, false, k++)), W,
                 [=](int r, int c, float acc) { bias_relu(r, c, rnd<T>(acc)); });
    }
    __syncwarp();
    if (KEEP != KEEP_NONE) keep_bits(ho, ldw, W, vr, bits + i * nw, rb.mw);
    dw.buf(A_H + i, ho, ldw);
    hn = h;
    h = ho;
  }

  // sigma head: f32 accumulation plus f32 bias
  {
    const T* sw = tw.w + L.sig_w;
    const float sb = tw.b[L.sig_b];
    for (int r = threadIdx.x & (LANES - 1); r < vr; r += LANES) {
      float acc = 0.f;
      for (int c = 0; c < W; ++c) acc = fmaf(to_f<T>(h[r * ldw + c]), to_f<T>(sw[c]), acc);
      zs[r] = acc + sb;
    }
  }
  if (!DIR) {
    __syncwarp();
    return;
  }
  // final = h @ fin_w + fin_b (no activation), into hn
  {
    const float* fb = tw.b + L.fin_b;
    T* fin = hn;
    warp_mm<T>(SmemA<T>{h, ldw}, W, st.get(tw, mat_at(d, L, false, k++)), W,
               [=](int r, int c, float acc) {
                 fin[r * ldw + c] = from_f<T>(rnd<T>(rnd<T>(acc) + rnd<T>(fb[c])));
               });
  }
  __syncwarp();
  dw.buf(A_H + d.depth, hn, ldw);
  // de = relu(final @ dir_wh + embd @ dir_wd + dir_b), into h
  T* de = h;
  {
    const float* db = tw.b + L.dir_b;
    warp_mm<T>(SmemA<T>{hn, ldw}, W, st.get(tw, mat_at(d, L, false, k++)), H,
               [=](int r, int c, float acc) { de[r * ldh + c] = from_f<T>(acc); });
    warp_mm<T>(SmemA<T>{wb.xd, ldd}, Ed, st.get(tw, mat_at(d, L, false, k++)), H,
               [=](int r, int c, float acc) {
                 float z = rnd<T>(to_f<T>(de[r * ldh + c]) + rnd<T>(acc));
                 z = rnd<T>(z + rnd<T>(db[c]));
                 de[r * ldh + c] = from_f<T>(fmaxf(z, 0.f));
               });
  }
  __syncwarp();
  dw.buf(A_DE, de, ldh);
  if constexpr (KEEP != KEEP_NONE) keep_bits(de, ldh, H, vr, bits + d.depth * nw, rb.mw);
  if constexpr (KEEP == KEEP_RENDER) {
    // rgb head (the three rgb columns; the features never reach the
    // composite's backward): f32 accumulation plus f32 bias
    const T* rw = tw.w + L.rgb_w;
    const float* rbias = tw.b + L.rgb_b;
    for (int j = threadIdx.x & (LANES - 1); j < vr * 3; j += LANES) {
      const int r = j / 3, c = j - 3 * r;
      float acc = 0.f;
      for (int q = 0; q < H; ++q) acc = fmaf(to_f<T>(de[r * ldh + q]), to_f<T>(rw[q * C + c]), acc);
      rb.rgb[(s0 + r) * 3 + c] = acc + rbias[c];
    }
  }
  __syncwarp();
}

// The tower backward of one warp over samples [s0, s0 + 16) (vr of them
// valid) from the state warp_forward kept (KEEP): the sigma head's
// cotangent dzs[0, 16) (unrounded, the sigmoid applied) and, DIR, the
// rgb/feature head's A operand grf(r, c), the cotangent rounded to T (0
// past vr rows and 3 + F columns); writes the embedding cotangents (or,
// RAW, the point and direction cotangents) of the valid rows; without DIR
// (the field's sigma mode) the backward starts at the last hidden layer
// and writes no direction cotangents. dw: the G operands of the dW
// products (the dir layer's, final's and every hidden layer's output
// cotangent; the caller writes the heads'). The render backward's pass 2
// (grf = w_r g_c) and the field backward (the rows' head cotangents).
template <typename T, bool RAW, bool DIR = true, typename St, typename GRf,
          typename Dw = WarpDw<T, false>>
__device__ __forceinline__ void warp_backward(const Tower<T>& tw, const RayBufs& rb, St& st,
                                              int wp, int s0, int S, size_t sample0, const void* x,
                                              const void* dirs, void* dx, void* ddirs,
                                              const float* dzs, GRf grf, const Dw& dw = Dw{}) {
  const Dims& d = tw.d;
  const Layout& L = tw.L;
  const int W = d.width, H = W / 2, E = d.E, Ed = d.Ed, C = 3 + d.F, nw = (W + 31) / 32;
  const int ldw = ld_of(W), ldh = ld_of(H), mw = rb.mw;
  const int vr = S - s0 < 0 ? 0 : (S - s0 < WR ? S - s0 : WR);
  const WarpBufs<T> wb = warp_bufs<T>(d, rb, wp, false, DIR);
  const uint32_t* bits = rb.mask + (size_t)s0 * mw;
  // relu' of unit c of word block `w0` (a layer) for row r
  auto on = [=](int r, int w0, int c) {
    return r < vr && ((bits[r * mw + w0 + (c >> 5)] >> (c & 31)) & 1u);
  };
  const T* sw = tw.w + L.sig_w;
  int k = DIR ? 0 : BWD_HEADS;
  // d_h of the last hidden layer, times its relu', into hb
  T* cur = wb.hb;
  float* dembd = reinterpret_cast<float*>(wb.xd);
  if constexpr (DIR) {
    // d_de = grf @ rgb_w^T (every channel: the features reach the head),
    // times relu'(de), into xe
    T* dzd = wb.xe;
    warp_mm<T>(FnA<GRf>{grf}, C, st.get(tw, mat_at(d, L, true, k++)), H,
               [=](int r, int c, float acc) {
                 dzd[r * ldh + c] = from_f<T>(on(r, d.depth * nw, c) ? acc : 0.f);
               });
    __syncwarp();
    dw.buf(G_DIR, dzd, ldh);
    // d_final = dzd @ dir_wh^T rounded, into ha; d_embd = dzd @ dir_wd^T
    // in f32, into xd
    T* dfin = wb.ha;
    {
      const SmemA<T> a{dzd, ldh};
      warp_mm<T>(a, H, st.get(tw, mat_at(d, L, true, k++)), W,
                 [=](int r, int c, float acc) { dfin[r * ldw + c] = from_f<T>(acc); });
      warp_mm<T>(a, H, st.get(tw, mat_at(d, L, true, k++)), Ed,
                 [=](int r, int c, float acc) { dembd[r * Ed + c] = acc; });
    }
    __syncwarp();
    dw.buf(G_FIN, dfin, ldw);
    // the sigma head's and final's cotangents, each rounded, summed in T
    const int w0 = (d.depth - 1) * nw;
    T* o = cur;
    warp_mm<T>(SmemA<T>{dfin, ldw}, W, st.get(tw, mat_at(d, L, true, k++)), W,
               [=](int r, int c, float acc) {
                 o[r * ldw + c] = from_f<T>(
                     on(r, w0, c) ? rnd<T>(rnd<T>(rnd<T>(dzs[r]) * to_f<T>(sw[c])) + rnd<T>(acc))
                                  : 0.f);
               });
  } else {
    // the sigma head's cotangent alone
    const int w0 = (d.depth - 1) * nw;
    for (int i = threadIdx.x & (LANES - 1); i < WR * W; i += LANES) {
      const int r = i / W, c = i - r * W;
      cur[r * ldw + c] =
          from_f<T>(on(r, w0, c) ? rnd<T>(rnd<T>(dzs[r]) * to_f<T>(sw[c])) : 0.f);
    }
  }
  __syncwarp();
  // the hidden layers, last to first; d_emb sums the skip layers' and the
  // first layer's products in f32, in that order, into xe
  float* demb = reinterpret_cast<float*>(wb.xe);
  T* nxt = wb.ha;
  bool first = true;
  for (int i = d.depth - 1; i >= 0; --i) {
    dw.buf(G_DZ + i, cur, ldw);
    const SmemA<T> a{cur, ldw};
    auto add_emb = [=](int r, int c, float acc) {
      demb[r * E + c] = first ? acc : demb[r * E + c] + acc;
    };
    if (i == 0) {
      warp_mm<T>(a, W, st.get(tw, mat_at(d, L, true, k++)), E, add_emb);
      break;
    }
    const int w0 = (i - 1) * nw;
    T* o = nxt;
    warp_mm<T>(a, W, st.get(tw, mat_at(d, L, true, k++)), W, [=](int r, int c, float acc) {
      o[r * ldw + c] = from_f<T>(on(r, w0, c) ? acc : 0.f);
    });
    if ((d.skipmask >> i) & 1) {
      warp_mm<T>(a, W, st.get(tw, mat_at(d, L, true, k++)), E, add_emb);
      first = false;
    }
    __syncwarp();
    nxt = cur;
    cur = o;
  }
  __syncwarp();

  // out: the embedding cotangents in T, or RAW through the embedding
  const size_t s = sample0 + s0;
  if (RAW) {
    const float* px = static_cast<const float*>(x);
    const float* pd = static_cast<const float*>(dirs);
    float* ox = static_cast<float*>(dx);
    float* od = static_cast<float*>(ddirs);
    for (int i = threadIdx.x & (LANES - 1); i < vr * 3; i += LANES) {
      const int r = i / 3, j = i - 3 * r;
      ox[s * 3 + i] = embed_grad(demb + r * E, px[(s + r) * 3 + j], j, E);
      if (DIR) od[s * 3 + i] = embed_grad(dembd + r * Ed, pd[(s + r) * 3 + j], j, Ed);
    }
  } else {
    T* ox = static_cast<T*>(dx);
    T* od = static_cast<T*>(ddirs);
    for (int i = threadIdx.x & (LANES - 1); i < vr * E; i += LANES)
      ox[s * E + i] = from_f<T>(demb[i]);
    if (DIR)
      for (int i = threadIdx.x & (LANES - 1); i < vr * Ed; i += LANES)
        od[s * Ed + i] = from_f<T>(dembd[i]);
  }
  __syncwarp();
}

// ---- the composite and its backward, across one warp

// In-place inclusive scan of a[0..31], forward (a[l] += a[l - d]) or
// backward (a[l] += a[l + d]), in Kogge-Stone order: d = 1, 2, 4, 8, 16,
// each step reading the previous step's values. One warp (the host build:
// one thread, in the same order).
__device__ inline void warp_scan32(float* a, bool backward) {
#ifndef NEFES_EMULATE
  const int l = threadIdx.x & 31;
  float v = a[l];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = backward ? __shfl_down_sync(0xffffffffu, v, d)
                             : __shfl_up_sync(0xffffffffu, v, d);
    if (backward ? l + d < 32 : l >= d) v += u;
  }
  __syncwarp();
  a[l] = v;
  __syncwarp();
#else
  for (int d = 1; d < 32; d <<= 1) {
    if (!backward)
      for (int l = 31; l >= d; --l) a[l] += a[l - d];
    else
      for (int l = 0; l + d < 32; ++l) a[l] += a[l + d];
  }
#endif
}

// One warp: the composite weights of samples [i0, i1) of a ray of S
// (i0 a multiple of 32): w_i = alpha_i T_i, T_i the exp of carry plus the
// exclusive prefix sum from i0 of log(max(1 - alpha_j, 1e-10)), each
// handed to out(i, alpha_i, T_i); returns the carry past i1. zs_at(i):
// sample i's sigma pre-activation; z: the ray's depths. Summation order:
// chunks of 32 samples, each a Kogge-Stone scan (warp_scan32) added to the
// running total of the chunks before it, so the forward's tile-by-tile
// calls add in the backward's order; the serial loop of the plain version
// adds one sample at a time, so the two differ by f32 rounding only.
template <typename Zs, typename Out>
__device__ __forceinline__ float composite_scan(int i0, int i1, int S, const float* z, Zs zs_at,
                                                float carry, float* scan, Out out) {
  const int lane0 = threadIdx.x & (LANES - 1);
  auto alpha_at = [&](int i) {
    const float delta = i + 1 < S ? z[i + 1] - z[i] : DELTA_INF;
    return 1.f - expf(-delta * softplus(zs_at(i)));
  };
  for (int c0 = i0; c0 < i1; c0 += 32) {
    for (int l = lane0; l < 32; l += LANES) {
      const int i = c0 + l;
      scan[l] = i < i1 ? logf(fmaxf(1.f - alpha_at(i), LOG_EPS)) : 0.f;
    }
    __syncwarp();
    warp_scan32(scan, false);
    for (int l = lane0; l < 32 && c0 + l < i1; l += LANES)
      out(c0 + l, alpha_at(c0 + l), expf(l ? carry + scan[l - 1] : carry));
    carry += scan[31];
    __syncwarp();
  }
  return carry;
}

// Warp 0 of the backward's block: the composite weights (composite_scan
// over the whole ray into rb.wgt, rb.trans) and, from the ray's cotangent
// gr, the cotangents of zs (rb.dzs), of the deltas (rb.dd) and of z (d_z),
// the suffix sums sum_{k > i} d_w_k w_k in chunks of 32 added to the
// running total of the chunks after them.
__device__ __forceinline__ void ray_composite(const RayBufs& rb, int S, int C,
                                              float* __restrict__ d_z) {
  const int lane0 = threadIdx.x & (LANES - 1);
  float* scan = rb.scan;
  auto delta_at = [&](int i) { return i + 1 < S ? rb.z[i + 1] - rb.z[i] : DELTA_INF; };
  composite_scan(0, S, S, rb.z, [&](int i) { return rb.zs[i]; }, 0.f, scan,
                 [&](int i, float alpha, float t) {
                   rb.trans[i] = t;
                   rb.wgt[i] = alpha * t;
                 });
  const float* gr = rb.gr;
  const float g_depth = gr[C], g_acc = gr[C + 1];
  auto d_w_at = [&](int i) {
    const float* rgb = rb.rgb + i * 3;
    return (rgb[0] * gr[0] + rgb[1] * gr[1] + rgb[2] * gr[2]) + rb.z[i] * g_depth + g_acc;
  };
  float carry = 0.f;
  for (int c0 = (S - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
    for (int l = lane0; l < 32; l += LANES) {
      const int i = c0 + l;
      scan[l] = i < S ? d_w_at(i) * rb.wgt[i] : 0.f;
    }
    __syncwarp();
    warp_scan32(scan, true);
    for (int l = lane0; l < 32 && c0 + l < S; l += LANES) {
      const int i = c0 + l;
      const float suffix = l < 31 ? carry + scan[l + 1] : carry;   // sum_{k > i}
      const float delta = delta_at(i), zs = rb.zs[i], sig = softplus(zs);
      const float alpha = 1.f - expf(-delta * sig);
      const float d_alpha = d_w_at(i) * rb.trans[i] - suffix / fmaxf(1.f - alpha, LOG_EPS);
      const float exp_term = expf(-delta * sig);
      rb.dzs[i] = (d_alpha * delta * exp_term) * sigmoid(zs);   // softplus' = sigmoid
      // the last delta is the constant tail: no z cotangent
      rb.dd[i] = i + 1 < S ? d_alpha * sig * exp_term : 0.f;
    }
    carry += scan[0];
    __syncwarp();
  }
  // delta_i = z_{i+1} - z_i  =>  d_z_i = w_i g_depth + d_delta_{i-1} - d_delta_i
  for (int i = lane0; i < S; i += LANES)
    d_z[i] = (rb.wgt[i] * g_depth + (i > 0 ? rb.dd[i - 1] : 0.f)) - rb.dd[i];
}

}  // namespace nefes
