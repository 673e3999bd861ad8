// Fused NeRFH-NFF field on Hopper: the tower and its heads (forward) and
// the recompute backward, with or without the weight gradients, on
// pre-embedded rows (K1, K2) or on raw points and directions that each
// warp embeds itself (K5, K6); modes sigma, full and transient.
//
// K1 replaces _run_fwd_pre / _fwd_kernel_pre (nefes_tpu/kernels/
// fused_field.py:686-709, 402-416); K2 replaces _run_bwd_pre /
// _bwd_kernel_pre (fused_field.py:712-741, 419-459), need_dw False or
// True. K5 replaces _run_fwd / _fwd_kernel (fused_field.py:597-619,
// 332-338): the embedding in the kernel in place of K1's row load, heads
// written in f32. K6 replaces _run_bwd / _bwd_kernel
// (fused_field.py:622-648, 341-367): K2 with f32 head cotangents and an
// epilogue (embed_grad) that takes the embedding cotangents, still in
// shared memory, to d_pts / d_dirs, recomputing the phases instead of
// storing them. With need_dw the backward also gives one f32
// gradient per packed weight (the TPU kernel's VMEM accumulators,
// fused_field.py:354-358, 440-444, 634-637, 728-731): the caller runs
// K2/K6 over chunks of rows, each launch writing the chunk's dW operands
// (tower.cuh's slot layout) and per-tile head bias sums, then field_dw_kernel
// (field_dw.cuh) over the chunk, which adds the products into `slices` f32
// partials; field_dw_reduce sums the slices in order.
//
// Bound on an H100: operations, not bytes. The forward takes 0.262 MFLOP
// a sample in sigma mode and 0.331 in full mode at D8/W128/F128 (0.37 in
// transient mode); the frozen backward about twice that, with dW three
// times; the embedding adds about 1 kFLOP and 66 sin/cos a sample. The
// bytes are at most ~0.7 KB a sample, plus, with dW, the operands written
// (about 6 KB a sample in bf16, transient mode at D8/W128/F128).
//
// K1/K5 in every mode (field_warp_kernel) run render_bwd.cuh's warp path,
// the render kernels' tower: a persistent grid of `blocks` blocks (one an
// SM: the block's shared memory holds two weight stages and eight warp
// tiles), each walking block tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of BT = 128 samples; warp w owns the tile's rows [16 w, 16 w + 16)
// through every layer (warp_forward, cut after the sigma head in sigma
// mode, where dirs is not read), in bf16 rows that ldmatrix feeds to
// mma.sync, the weights staged matrix by matrix by cp.async in the
// sequence of the mode (SEQ_SIGMA: the hidden layers; SEQ_HEADS: those,
// final, the dir layer and the rgb/feature head, read from wt as (N, K);
// SEQ_TRANSIENT: those and the NeRF-W branch, t1's two, t2, t3 and the
// five transient head columns), the next tile's first matrix copied
// during this tile's last product. The transient branch's 64-wide layers
// reuse the warp's two hidden-layer buffers once their contents are dead
// (de after the rgb/feature head, final after t1), so transient mode
// takes the shared memory of full mode. f32 runs the same kernel on the
// CUDA cores (the host build checks it).
//
// K2/K6 in every mode (field_bwd_warp_kernel) run the same warp path: a
// persistent grid of one block an SM walks block tiles of the chunk's
// rows; each warp runs warp_forward over its 16 rows (in transient mode
// on through the NeRF-W branch, warp_transient, without the rgb/feature
// head, whose cotangent is an input), keeping their ReLU bits and the
// sigma and transient head pre-activations in shared memory, and at once
// warp_backward from that state, so no forward is rerun and no state
// crosses warps. The stager copies each tile's forward sequence and then
// its backward's (ORD_TILE; sigma mode's backward starts at the last
// hidden layer; transient mode's also runs the branch's products, bwd_mat).
// With dW the warps write their rows' operands by streaming stores in
// tower.cuh's slot layout, and the head biases' sums go to tile_b per
// 64-row tile (warps 0-3 and 4-7 of a block tile, in warp order), which
// field_dw_kernel reads.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "field_dw.cuh"

namespace nefes {

// the type of the heads and their cotangents: the pack dtype T on the
// pre-embedded kernels, f32 on the raw-input ones (as the TPU kernels)
template <typename T, bool RAW>
using Head = typename std::conditional<RAW, float, T>::type;

// The forward sequence field_warp_kernel stages in `mode`.
__host__ __device__ constexpr Seq seq_of(int mode) {
  return mode == SIGMA ? SEQ_SIGMA : mode == FULL ? SEQ_HEADS : SEQ_TRANSIENT;
}

// Carve one block of field_warp_kernel in forward sequence FWD from base
// (nullptr: size only): two weight stages of the sequence's largest
// matrix (a 2-byte pack dtype stages its weights), eight lean warp
// regions (the embedding rows, the dir embedding rows unless SEQ_SIGMA,
// two hidden-layer buffers; the dir layer's output and the transient
// layers overwrite them) and the tile's sigma pre-activations; returns the
// bytes used.
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
  t.wbytes = warp_layout(d, ts, true, FWD != SEQ_SIGMA).total;
  t.warps = bytes(WARPS * t.wbytes);
  t.tzs = take(base, &off, BT);
  if (rb) *rb = t;
  return off;
}

// The NeRF-W transient branch of warp wp after warp_forward (DIR) left the
// dir layer's output de and final in its two hidden-layer buffers (LEAN:
// the field forward's warp layout), with vr of its 16 rows [s0, s0 + 16)
// of the block tile valid: t1 = relu(rnd(rnd(final t1_wh) + rnd(embd
// t1_wd)) + rnd(t1_b)) over de (read by the rgb/feature head before, or
// dead), t2 = relu(rnd(rnd(t1 t2_w) + rnd(t2_b))) over final (dead after
// t1), t3 likewise over t1, then the five transient heads' pre-activations
// (f32 sums plus the f32 biases [ts_b, tr_b x3, tb_b]) to head(r, c, z) for
// every row. Its matrices are the last five of FWD, from k (the kernel
// counts it once: fwd_count walks the sequence). KEEP: t1, t2 and t3's
// ReLU bits after the dir layer's in rb.mask; dw: their A operands, each
// before it is overwritten. Every warp runs every product, so the
// stager's barriers line up whatever its valid rows.
template <typename T, Seq FWD, bool LEAN, bool KEEP, typename St, typename HeadFn,
          typename Dw = WarpDw<T, false>>
__device__ __forceinline__ void warp_transient(const Tower<T>& tw, const RayBufs& rb, St& st,
                                               int wp, int s0, int vr, int k, HeadFn head,
                                               const Dw& dw = Dw{}) {
  const Dims& d = tw.d;
  const Layout& L = tw.L;
  const int W = d.width, H = W / 2, ldw = ld_of(W), ldh = ld_of(H), nh = (H + 31) / 32;
  const WarpBufs<T> wb = warp_bufs<T>(d, rb, wp, LEAN);
  T* hd = const_cast<T*>(warp_de<T>(d, rb, wp, LEAN));
  T* hf = hd == wb.ha ? wb.hb : wb.ha;
  uint32_t* bits = KEEP ? rb.mask + (size_t)s0 * rb.mw + d.depth * ((W + 31) / 32) + nh : nullptr;
  const float* b1 = tw.b + L.t1_b;
  __syncwarp();
  warp_mm<T>(SmemA<T>{hf, ldw}, W, st.get(tw, fwd_mat<FWD>(d, L, k++)), H,
             [=](int r, int c, float acc) { hd[r * ldh + c] = from_f<T>(acc); });
  warp_mm<T>(SmemA<T>{wb.xd, ld_of(d.Ed)}, d.Ed, st.get(tw, fwd_mat<FWD>(d, L, k++)), H,
             [=](int r, int c, float acc) {
               float z = rnd<T>(to_f<T>(hd[r * ldh + c]) + rnd<T>(acc));
               z = rnd<T>(z + rnd<T>(b1[c]));
               hd[r * ldh + c] = from_f<T>(fmaxf(z, 0.f));
             });
  T* io[3] = {hd, hf, hd};   // t1 -> t2 -> t3
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    T* o = io[l];
    if (l) {
      const T* a = io[l - 1];
      const float* bb = tw.b + (l == 2 ? L.t3_b : L.t2_b);
      __syncwarp();
      warp_mm<T>(SmemA<T>{a, ldh}, H, st.get(tw, fwd_mat<FWD>(d, L, k++)), H,
                 [=](int r, int c, float acc) {
                   const float z = rnd<T>(rnd<T>(acc) + rnd<T>(bb[c]));
                   o[r * ldh + c] = from_f<T>(fmaxf(z, 0.f));
                 });
    }
    __syncwarp();
    if constexpr (KEEP) keep_bits(o, ldh, H, vr, bits + l * nh, rb.mw);
    dw.buf(A_T1 + l, o, ldh);
  }
  // the five heads from t3: bias [ts_b, tr_b x3, tb_b] back to back
  const float* tb = tw.b + L.ts_b;
  __syncwarp();
  warp_mm<T>(SmemA<T>{hd, ldh}, H, st.get(tw, fwd_mat<FWD>(d, L, k)), 5,
             [=](int r, int c, float acc) { head(r, c, acc + tb[c]); });
  __syncwarp();
}

// K1 (pre-embedded x, dirs in T, heads in T) and K5 (RAW: f32 points and
// directions, heads in f32) in MODE: sigma (sigma (N,) only; dirs not
// read), full (also rgb (N, 3) and feat (N, F)) or transient (also the
// transient heads (N, 5): [sigma, rgb x3, beta] after softplus / sigmoid x3
// / softplus, warp_transient). sigma = softplus(zs), zs the sigma head's
// f32 sum plus its f32 bias; the rgb/feature and transient heads
// accumulate in f32 plus their f32 bias, written in the head type.
template <typename T, bool RAW, int MODE>
__global__ void __launch_bounds__(NT, 1)
field_warp_kernel(Tower<T> tw, int n, const void* __restrict__ x, const void* __restrict__ dirs,
                  Head<T, RAW>* __restrict__ sigma, Head<T, RAW>* __restrict__ rgb,
                  Head<T, RAW>* __restrict__ feat, Head<T, RAW>* __restrict__ trans) {
  using O = Head<T, RAW>;
  extern __shared__ __align__(16) char nefes_smem[];
  constexpr Seq FWD = seq_of(MODE);
  constexpr bool HEADS = MODE != SIGMA;
  RayBufs rb;
  carve_field<FWD>(tw.d, tw.L, sizeof(T), nefes_smem, &rb);
  const int H = tw.d.width / 2, F = tw.d.F, ldh = ld_of(H);
  const int k_rgb = fwd_count<SEQ_HEADS>(tw.d, tw.L) - 1;   // the rgb/feature head in FWD
  const int tiles = (n + BT - 1) / BT, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, mine = b < tiles ? (tiles - 1 - b) / (int)gridDim.x + 1 : 0;
  Stager<T, FWD> st(tw, rb, mine, false);   // the block's tiles b, b + gridDim.x, ...
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int wp = warp; wp < WARPS; wp += WARP_STEP) {
      const int s0 = t * BT + wp * WR;
      const int vr = n - s0 < 0 ? 0 : (n - s0 < WR ? n - s0 : WR);
      float* zs = rb.tzs + wp * WR;
      warp_forward<T, RAW, KEEP_NONE, HEADS, true>(tw, rb, st, wp, s0, n, 0, x, dirs, zs);
      if constexpr (HEADS) {
        const T* de = warp_de<T>(tw.d, rb, wp, true);
        const float* rbias = tw.b + tw.L.rgb_b;
        warp_mm<T>(SmemA<T>{de, ldh}, H, st.get(tw, fwd_mat<FWD>(tw.d, tw.L, k_rgb)), 3 + F,
                   [=](int r, int c, float acc) {
                     if (r >= vr) return;
                     const size_t row = (size_t)s0 + r;
                     const O v = from_f<O>(acc + rbias[c]);
                     if (c < 3) rgb[row * 3 + c] = v;
                     else feat[row * F + (c - 3)] = v;
                   });
        if constexpr (MODE == TRANSIENT)
          warp_transient<T, FWD, true, false>(tw, rb, st, wp, wp * WR, vr, k_rgb + 1,
                                              [=](int r, int c, float z) {
                                                if (r < vr)
                                                  trans[((size_t)s0 + r) * 5 + c] =
                                                      from_f<O>(transient_head(z, c));
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
  return mode == TRANSIENT ? carve_field<SEQ_TRANSIENT>(d, L, ts, nullptr, nullptr)
         : mode == FULL    ? carve_field<SEQ_HEADS>(d, L, ts, nullptr, nullptr)
                           : carve_field<SEQ_SIGMA>(d, L, ts, nullptr, nullptr);
}

// K1/K5 in MODE on the warp path.
template <typename T, bool RAW, int MODE>
int launch_fwd(int n, const void* x, const void* dirs, const void* w, const void* wt,
               const float* b, Dims d, void* sigma, void* rgb, void* feat, void* trans,
               int blocks, void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = fwd_smem(d, sizeof(T), MODE);
  auto* kern = &field_warp_kernel<T, RAW, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + BT - 1) / BT;
  const int grid = blocks > 0 && blocks < tiles ? blocks : tiles;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, wt, b, d), n, x, dirs,
               static_cast<O*>(sigma), static_cast<O*>(rgb), static_cast<O*>(feat),
               static_cast<O*>(trans));
  return (int)cudaGetLastError();
}

// The recompute's forward sequence and the stager's order of the
// backward K2/K6 in `mode`.
__host__ __device__ constexpr Seq bwd_seq(int mode) {
  return mode == SIGMA ? SEQ_SIGMA : mode == FULL ? SEQ_DIR : SEQ_TRANSIENT_BWD;
}

__host__ __device__ constexpr Order bwd_order(int mode) {
  return mode == SIGMA ? ORD_TILE_SIGMA : mode == FULL ? ORD_TILE : ORD_TILE_TRANSIENT;
}

// Carve one block of field_bwd_warp_kernel in MODE from base (nullptr:
// size only): two weight stages of the largest matrix of the forward
// sequence and of the backward's (a 2-byte pack dtype stages its weights),
// eight full warp regions (warp_layout, the dir rows but in sigma mode),
// the block tile's ReLU bits (BT x mw words: the hidden layers', the dir
// layer's and in transient mode t1, t2 and t3's), sigma pre-activations
// and their cotangents, in transient mode the five transient heads'
// pre-activations (BT x 5), the warps' head bias sums (WARPS x (4 + F),
// transient mode 5 more) and the dW slot table (2 x N_SLOTS ints, into
// *slots); returns the bytes used.
template <int MODE>
__host__ __device__ inline size_t carve_field_bwd(const Dims& d, const Layout& L, int ts,
                                                  char* base, RayBufs* rb, int** slots) {
  constexpr bool TRANS = MODE == TRANSIENT;
  constexpr Seq FWD = bwd_seq(MODE);
  constexpr Order ORD = bwd_order(MODE);
  RayBufs t{};
  size_t off = 0;
  auto bytes = [&](size_t n) {
    char* p = base ? base + off : nullptr;
    off += (n + 15) / 16 * 16;
    return p;
  };
  size_t stage = 0;
  if (ts == 2) {
    for (int k = 0; k < fwd_count<FWD>(d, L); ++k) {
      const size_t e = staged_elems(fwd_mat<FWD>(d, L, k));
      stage = stage > e ? stage : e;
    }
    for (int k = 0; k < bwd_count<ORD>(d, L); ++k) {
      const size_t e = staged_elems(bwd_mat<ORD>(d, L, k));
      stage = stage > e ? stage : e;
    }
  }
  t.wbuf[0] = bytes(stage * ts);
  t.wbuf[1] = bytes(stage * ts);
  t.wbytes = warp_layout(d, ts, false, MODE != SIGMA).total;
  t.warps = bytes(WARPS * t.wbytes);
  t.mw = d.depth * ((d.width + 31) / 32) + (TRANS ? 4 : 1) * ((d.width / 2 + 31) / 32);
  t.mask = reinterpret_cast<uint32_t*>(take(base, &off, (size_t)BT * t.mw));
  t.zs = take(base, &off, BT);
  t.dzs = take(base, &off, BT);
  if (TRANS) t.tz = take(base, &off, (size_t)BT * 5);
  t.part = take(base, &off, (size_t)WARPS * (4 + d.F + (TRANS ? 5 : 0)));
  int* sl = reinterpret_cast<int*>(take(base, &off, 2 * N_SLOTS));
  if (rb) *rb = t;
  if (slots) *slots = sl;
  return off;
}

// K2 (pre-embedded x, dirs and head cotangents in T; dx, ddirs (N, E),
// (N, Ed) in T) and K6 (RAW: f32 points, directions and cotangents; d_pts,
// d_dirs (N, 3) in f32) in MODE over rows [row0, row0 + rows): a
// persistent grid of blocks walking block tiles of BT rows of the chunk
// (tile t its rows [t BT, t BT + BT), whatever row0 is); warp w runs
// warp_forward over its 16 rows (in transient mode on through
// warp_transient, without the rgb/feature head), keeping their ReLU bits,
// sigma and transient head pre-activations, and then warp_backward from
// that state, the weights staged tile by tile in forward-then-backward
// order (ORD_TILE*). The cotangents round where the plain version's do:
// dzs = g_sigma sigmoid(zs) unrounded, the rgb/feature head's A operand
// g_rgb | g_feat rounded to T, the transient heads' (g_trans (N, 5))
// through softplus' / sigmoid' in f32, the last hidden layer's
// rnd(rnd(rnd(dzs) sw) + rnd(d_final)) (sigma mode: rnd(rnd(dzs) sw)). DW:
// also the chunk's dW operands in ops (A slots from the forward, G slots
// from the backward, by streaming stores) and the head biases' sums
// (sigma; full mode also rgb/feature; transient mode also the transient
// heads) over each 64-row tile of the chunk in its row of tile_b (nb
// floats a tile): the tile's four warps' row-order sums, added in warp
// order.
template <typename T, bool RAW, int MODE, bool DW>
__global__ void __launch_bounds__(NT, 1)
field_bwd_warp_kernel(Tower<T> tw, int row0, int rows, const void* __restrict__ x,
                      const void* __restrict__ dirs, const Head<T, RAW>* __restrict__ g_sigma,
                      const Head<T, RAW>* __restrict__ g_rgb,
                      const Head<T, RAW>* __restrict__ g_feat,
                      const Head<T, RAW>* __restrict__ g_trans, void* __restrict__ dx,
                      void* __restrict__ ddirs, T* __restrict__ ops, float* __restrict__ tile_b,
                      int nb) {
  using O = Head<T, RAW>;
  constexpr bool DIR = MODE != SIGMA, TRANS = MODE == TRANSIENT;
  static_assert(BT == 2 * TR, "a block tile holds two of tile_b's 64-row tiles");
  extern __shared__ __align__(16) char nefes_smem[];
  RayBufs rb;
  int* slots;
  carve_field_bwd<MODE>(tw.d, tw.L, sizeof(T), nefes_smem, &rb, &slots);
  // P: the head bias sums of a warp, [sigma, rgb/feature (C), transient (5)]
  const int F = tw.d.F, C = 3 + F, P = 1 + C + (TRANS ? 5 : 0);
  const int k_tr = fwd_count<bwd_seq(MODE)>(tw.d, tw.L) - 5;   // t1_wh in the sequence
  const int tiles = (rows + BT - 1) / BT, warp = threadIdx.x >> 5;
  const int lane0 = threadIdx.x & (LANES - 1);
  const int b = blockIdx.x, mine = b < tiles ? (tiles - 1 - b) / (int)gridDim.x + 1 : 0;
  if (DW) {
    dw_table(tw.d, MODE, slots);
    __syncthreads();
  }
  Stager<T, bwd_seq(MODE), bwd_order(MODE)> st(tw, rb, mine, true);
  for (int t = b; t < tiles; t += gridDim.x) {
    const int base = t * BT;   // the block tile's first row in the chunk
    for (int wp = warp; wp < WARPS; wp += WARP_STEP) {
      const int s0 = wp * WR, S = rows - base;
      const int vr = S - s0 < 0 ? 0 : (S - s0 < WR ? S - s0 : WR);
      const size_t row = (size_t)row0 + base + s0;   // the warp's first row
      float* zs = rb.zs + s0;
      float* dzs = rb.dzs + s0;
      float* dz5 = TRANS ? rb.tz + s0 * 5 : nullptr;
      const WarpDw<T, DW> dw{ops, slots, rows, base + s0, vr};
      warp_forward<T, RAW, KEEP_BITS, DIR>(tw, rb, st, wp, s0, S, row0 + base, x, dirs, zs, dw);
      if constexpr (TRANS) {
        warp_transient<T, bwd_seq(MODE), false, true>(
            tw, rb, st, wp, s0, vr, k_tr, [=](int r, int c, float z) { dz5[r * 5 + c] = z; }, dw);
        // the heads' cotangents through softplus / sigmoid x3 / softplus,
        // in f32, in place
        for (int i = lane0; i < WR * 5; i += LANES) {
          const int r = i / 5, j = i - 5 * r;
          const float g = r < vr ? to_f<O>(g_trans[(row + r) * 5 + j]) : 0.f;
          const float sg = sigmoid(dz5[i]);
          dz5[i] = (j == 0 || j == 4) ? g * sg : g * sg * (1.f - sg);
        }
      }
      for (int r = lane0; r < WR; r += LANES)
        dzs[r] = r < vr ? to_f<O>(g_sigma[row + r]) * sigmoid(zs[r]) : 0.f;   // softplus'
      __syncwarp();
      auto g_head = [=](int r, int c) {   // the rgb/feature head's cotangent, unrounded
        return c < 3 ? to_f<O>(g_rgb[(row + r) * 3 + c]) : to_f<O>(g_feat[(row + r) * F + c - 3]);
      };
      if constexpr (DW) {
        dw.fn(G_SIG, [=](int r, int) { return dzs[r]; });
        if (DIR) dw.fn(G_RGB, g_head);
        if (TRANS) {
          dw.fn(G_TS, [=](int r, int) { return dz5[r * 5]; });
          dw.fn(G_TR, [=](int r, int c) { return dz5[r * 5 + 1 + c]; });
          dw.fn(G_TB, [=](int r, int) { return dz5[r * 5 + 4]; });
        }
        float* part = rb.part + wp * P;
        for (int j = lane0; j < (DIR ? P : 1); j += LANES) {
          float acc = 0.f;
          for (int r = 0; r < vr; ++r)
            acc += j == 0 ? dzs[r] : !TRANS || j <= C ? g_head(r, j - 1) : dz5[r * 5 + j - 1 - C];
          part[j] = acc;
        }
      }
      warp_backward<T, RAW, DIR, TRANS>(
          tw, rb, st, wp, s0, S, row0 + base, x, dirs, dx, ddirs, dzs,
          [=](int r, int c) { return (r < vr && c < C) ? rnd<T>(g_head(r, c)) : 0.f; }, dw, dz5);
    }
    if constexpr (DW) {
      // the two 64-row tiles of the block tile: warps 0-3 and 4-7
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * P; i += blockDim.x) {
        const int h = i / P, j = i - h * P, t64 = 2 * t + h;
        if ((!DIR && j) || t64 * TR >= rows) continue;
        const float* p = rb.part + h * (WARPS / 2) * P + j;
        float acc = 0.f;
        for (int w = 0; w < WARPS / 2; ++w) acc += p[w * P];
        const int at = j == 0                ? tw.L.sig_b
                       : !TRANS || j <= C ? tw.L.rgb_b + j - 1
                                          : tw.L.ts_b + j - 1 - C;
        tile_b[(size_t)t64 * nb + at] = acc;
      }
      __syncthreads();
    }
  }
}

// Shared-memory bytes of one block of the backward K2/K6 in `mode`, in a
// pack dtype of ts bytes.
inline size_t bwd_smem(const Dims& d, int ts, int mode) {
  const Layout L = make_layout(d);
  return mode == SIGMA  ? carve_field_bwd<SIGMA>(d, L, ts, nullptr, nullptr, nullptr)
         : mode == FULL ? carve_field_bwd<FULL>(d, L, ts, nullptr, nullptr, nullptr)
                        : carve_field_bwd<TRANSIENT>(d, L, ts, nullptr, nullptr, nullptr);
}

// Blocks of kern (smem bytes of shared memory) that the current device
// holds at once: its SMs times the blocks an SM holds (1 in the host
// build); a negative CUDA error on a failure.
template <typename K>
int resident_blocks(K kern, size_t smem) {
#ifdef NEFES_EMULATE
  (void)kern, (void)smem;
  return 1;
#else
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, NT, smem);
  return err == cudaSuccess ? sms * per : -(int)err;
#endif
}

// K2/K6 in MODE on the warp path; blocks: the persistent grid (< 0:
// resident_blocks; 0: one block per block tile), at most one block per
// block tile.
template <typename T, bool RAW, int MODE, bool DW>
int launch_bwd_warp(int row0, int rows, const void* x, const void* dirs, const void* w,
                    const void* wt, const float* b, Dims d, const void* g_sigma,
                    const void* g_rgb, const void* g_feat, const void* g_trans, void* dx,
                    void* ddirs, void* ops, float* tile_b, int nb, int blocks, void* stream) {
  using O = Head<T, RAW>;
  const size_t smem = bwd_smem(d, sizeof(T), MODE);
  auto* kern = &field_bwd_warp_kernel<T, RAW, MODE, DW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 0) {
    blocks = resident_blocks(kern, smem);
    if (blocks <= 0) return blocks < 0 ? -blocks : -4;
  }
  const int tiles = (rows + BT - 1) / BT;
  const int grid = blocks > 0 && blocks < tiles ? blocks : tiles;
  NEFES_LAUNCH(kern, grid, smem, stream, make_tower<T>(w, wt, b, d), row0, rows, x, dirs,
               static_cast<const O*>(g_sigma), static_cast<const O*>(g_rgb),
               static_cast<const O*>(g_feat), static_cast<const O*>(g_trans), dx, ddirs,
               static_cast<T*>(ops), tile_b, nb);
  return (int)cudaGetLastError();
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

template <typename T>
int launch_dw(int mode, int rows, int slices, Dims d, const void* ops, const float* tile_b,
              int nw, int nb, float* part, void* stream) {
  const int jobs = dw_jobs(d, mode);
  NEFES_LAUNCH(field_dw_kernel<T>, slices * jobs, 0, stream, d, mode, rows, jobs, slices,
               static_cast<const T*>(ops), tile_b, nw, nb, part);
  return (int)cudaGetLastError();
}

template <bool RAW>
int field_fwd(int dtype, int mode, int n, const void* x, const void* dirs, const void* w,
              const void* wt, const float* b, Dims d, void* sigma, void* rgb, void* feat,
              void* trans, int blocks, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 1 && !HAS_BF16) return -1;
  if (mode < SIGMA || mode > TRANSIENT) return -2;
  auto go = [&](auto launch) {
    return launch(n, x, dirs, w, wt, b, d, sigma, rgb, feat, trans, blocks, stream);
  };
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return mode == SIGMA ? go(launch_fwd<bf16, RAW, SIGMA>)
           : mode == FULL ? go(launch_fwd<bf16, RAW, FULL>)
                          : go(launch_fwd<bf16, RAW, TRANSIENT>);
  return mode == SIGMA ? go(launch_fwd<float, RAW, SIGMA>)
         : mode == FULL ? go(launch_fwd<float, RAW, FULL>)
                        : go(launch_fwd<float, RAW, TRANSIENT>);
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
  if (mode == SIGMA) return blocks(&field_warp_kernel<T, RAW, SIGMA>);
  if (mode == FULL) return blocks(&field_warp_kernel<T, RAW, FULL>);
  return blocks(&field_warp_kernel<T, RAW, TRANSIENT>);
}
#endif

template <bool RAW>
int field_bwd(int dtype, int mode, int n, const void* x, const void* dirs, const void* w,
              const void* wt, const float* b, Dims d, const void* g_sigma, const void* g_rgb,
              const void* g_feat, const void* g_trans, void* dx, void* ddirs, int row0,
              int rows, int nb, void* ops, float* tile_b, int blocks, void* stream) {
  if (dtype == 1 && !HAS_BF16) return -1;
  if (mode < SIGMA || mode > TRANSIENT) return -2;
  if (row0 < 0 || rows < 0 || row0 + rows > n || (ops && (tile_b == nullptr || nb <= 0)))
    return -3;
  if (rows == 0) return 0;
  using bf16 = __nv_bfloat16;
  auto go = [&](auto launch) {
    return launch(row0, rows, x, dirs, w, wt, b, d, g_sigma, g_rgb, g_feat, g_trans, dx, ddirs,
                  ops, tile_b, nb, blocks, stream);
  };
  const bool dw = ops != nullptr;
  if (dtype == 1) {
    if (mode == SIGMA)
      return dw ? go(launch_bwd_warp<bf16, RAW, SIGMA, true>)
                : go(launch_bwd_warp<bf16, RAW, SIGMA, false>);
    if (mode == FULL)
      return dw ? go(launch_bwd_warp<bf16, RAW, FULL, true>)
                : go(launch_bwd_warp<bf16, RAW, FULL, false>);
    return dw ? go(launch_bwd_warp<bf16, RAW, TRANSIENT, true>)
              : go(launch_bwd_warp<bf16, RAW, TRANSIENT, false>);
  }
  if (mode == SIGMA)
    return dw ? go(launch_bwd_warp<float, RAW, SIGMA, true>)
              : go(launch_bwd_warp<float, RAW, SIGMA, false>);
  if (mode == FULL)
    return dw ? go(launch_bwd_warp<float, RAW, FULL, true>)
              : go(launch_bwd_warp<float, RAW, FULL, false>);
  return dw ? go(launch_bwd_warp<float, RAW, TRANSIENT, true>)
            : go(launch_bwd_warp<float, RAW, TRANSIENT, false>);
}

#ifndef NEFES_EMULATE
// Blocks of the backward K2 (or, RAW, K6) in `mode` that one SM holds,
// from the occupancy calculator; -1 on an error.
template <typename T, bool RAW>
int bwd_blocks_per_sm(const Dims& d, int mode) {
  const size_t smem = bwd_smem(d, sizeof(T), mode);
  auto blocks = [&](auto kern) {
    int nb = -1;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, NT, smem) != cudaSuccess)
      return -1;
    return nb;
  };
  if (mode == SIGMA) return blocks(&field_bwd_warp_kernel<T, RAW, SIGMA, false>);
  if (mode == FULL) return blocks(&field_bwd_warp_kernel<T, RAW, FULL, false>);
  return blocks(&field_bwd_warp_kernel<T, RAW, TRANSIENT, false>);
}
#endif

}  // namespace nefes

using nefes::Dims;

// dtype: 0 = float32, 1 = bfloat16 (the pack dtype of the weights and, on
// the pre-embedded kernels, of inputs, outputs and cotangents). mode: 0 =
// "sigma", 1 = "full", 2 = "transient". The transient heads and their
// cotangents are one (n, 5) array each. The forward: embd is not read in
// sigma mode (it may be null); blocks is the size of its persistent grid
// (nefes_field_blocks_per_sm a multiprocessor, at most one a block tile
// of 128 samples; 0: one a block tile).
extern "C" int nefes_field_fwd_pre(int dtype, int mode, int n, const void* emb,
                                   const void* embd, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, void* sigma, void* rgb, void* feat, void* trans,
                                   int blocks, void* stream) {
  return nefes::field_fwd<false>(dtype, mode, n, emb, embd, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, sigma, rgb, feat,
                                 trans, blocks, stream);
}

// The backward over rows [row0, row0 + rows) of the n rows. ops: null
// for the frozen field (need_dw=False: nb and tile_b are not read), else
// the dW operand buffer of a chunk of exactly those rows
// (nefes_field_dw_row_elems elements of the pack dtype a row) and tile_b,
// ceil(rows / 64) x nb f32 (nb the bias blob's length), whose entries the
// mode's head biases overwrite (the others are left as they are). In
// every mode a persistent grid of as many blocks as the card holds at once
// (nefes_field_bwd_blocks_per_sm a multiprocessor, at most one a block
// tile of 128 rows of the chunk); the _grid entry points take that grid's
// size (0: one block a block tile).
extern "C" int nefes_field_bwd_pre_grid(int dtype, int mode, int n, const void* emb,
                                        const void* embd, const void* w, const void* wt,
                                        const float* b, int depth, int width, int skipmask,
                                        int E, int Ed, int F, const void* g_sigma,
                                        const void* g_rgb, const void* g_feat,
                                        const void* g_trans, void* d_emb, void* d_embd, int row0,
                                        int rows, int nb, void* ops, float* tile_b, int blocks,
                                        void* stream) {
  return nefes::field_bwd<false>(dtype, mode, n, emb, embd, w, wt, b,
                                 Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb,
                                 g_feat, g_trans, d_emb, d_embd, row0, rows, nb, ops, tile_b,
                                 blocks, stream);
}

extern "C" int nefes_field_bwd_pre(int dtype, int mode, int n, const void* emb,
                                   const void* embd, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const void* g_sigma, const void* g_rgb,
                                   const void* g_feat, const void* g_trans, void* d_emb,
                                   void* d_embd, int row0, int rows, int nb, void* ops,
                                   float* tile_b, void* stream) {
  return nefes_field_bwd_pre_grid(dtype, mode, n, emb, embd, w, wt, b, depth, width, skipmask,
                                  E, Ed, F, g_sigma, g_rgb, g_feat, g_trans, d_emb, d_embd, row0,
                                  rows, nb, ops, tile_b, -1, stream);
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

extern "C" int nefes_field_bwd_raw_grid(int dtype, int mode, int n, const float* pts,
                                        const float* dirs, const void* w, const void* wt,
                                        const float* b, int depth, int width, int skipmask,
                                        int E, int Ed, int F, const float* g_sigma,
                                        const float* g_rgb, const float* g_feat,
                                        const float* g_trans, float* d_pts, float* d_dirs,
                                        int row0, int rows, int nb, void* ops, float* tile_b,
                                        int blocks, void* stream) {
  return nefes::field_bwd<true>(dtype, mode, n, pts, dirs, w, wt, b,
                                Dims{depth, width, skipmask, E, Ed, F}, g_sigma, g_rgb, g_feat,
                                g_trans, d_pts, d_dirs, row0, rows, nb, ops, tile_b, blocks,
                                stream);
}

extern "C" int nefes_field_bwd_raw(int dtype, int mode, int n, const float* pts,
                                   const float* dirs, const void* w, const void* wt,
                                   const float* b, int depth, int width, int skipmask, int E,
                                   int Ed, int F, const float* g_sigma, const float* g_rgb,
                                   const float* g_feat, const float* g_trans, float* d_pts,
                                   float* d_dirs, int row0, int rows, int nb, void* ops,
                                   float* tile_b, void* stream) {
  return nefes_field_bwd_raw_grid(dtype, mode, n, pts, dirs, w, wt, b, depth, width, skipmask,
                                  E, Ed, F, g_sigma, g_rgb, g_feat, g_trans, d_pts, d_dirs, row0,
                                  rows, nb, ops, tile_b, -1, stream);
}

// Elements of the pack dtype one row of a chunk's dW operands takes in
// `mode`.
extern "C" int nefes_field_dw_row_elems(int mode, int depth, int width, int skipmask, int E,
                                        int Ed, int F) {
  return nefes::dw_row_elems(Dims{depth, width, skipmask, E, Ed, F}, mode);
}

// Blocks of the dW kernel a row slice in `mode` (its products' 64 x 64
// output tiles, the biases' column sums among them, and its ranges of
// head bias sums).
extern "C" int nefes_field_dw_jobs(int mode, int depth, int width, int skipmask, int E, int Ed,
                                   int F) {
  return nefes::dw_jobs(Dims{depth, width, skipmask, E, Ed, F}, mode);
}

// The dW kernel over one chunk of `rows` rows: ops its operands and tile_b
// its tiles' head bias sums, as nefes_field_bwd_* left them; adds the chunk's
// weight gradients, `slices` row slices of it, into part (slices, nw + nb)
// f32 (the matrices at their offsets in w, then the biases at theirs).
extern "C" int nefes_field_dw(int dtype, int mode, int rows, int slices, int depth, int width,
                              int skipmask, int E, int Ed, int F, const void* ops,
                              const float* tile_b, int nw, int nb, float* part, void* stream) {
  if (dtype == 1 && !nefes::HAS_BF16) return -1;
  if (mode < nefes::SIGMA || mode > nefes::TRANSIENT) return -2;
  if (slices <= 0 || nb <= 0) return -3;
  if (rows <= 0) return 0;
  const Dims d{depth, width, skipmask, E, Ed, F};
  return dtype == 1 ? nefes::launch_dw<__nv_bfloat16>(mode, rows, slices, d, ops, tile_b, nw,
                                                      nb, part, stream)
                    : nefes::launch_dw<float>(mode, rows, slices, d, ops, tile_b, nw, nb, part,
                                              stream);
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

// Shared-memory bytes of one block of the backward K2/K6 in `mode`; dtype
// as above.
extern "C" int nefes_field_bwd_smem_bytes(int dtype, int mode, int depth, int width,
                                          int skipmask, int E, int Ed, int F) {
  if (mode < nefes::SIGMA || mode > nefes::TRANSIENT) return -1;
  return (int)nefes::bwd_smem(Dims{depth, width, skipmask, E, Ed, F}, dtype == 1 ? 2 : 4, mode);
}

// Blocks of the backward K2 (or, raw, K6) in `mode` that one SM holds,
// from the occupancy calculator (1 in the host build); -1 on an error.
extern "C" int nefes_field_bwd_blocks_per_sm(int dtype, int mode, int raw, int depth, int width,
                                             int skipmask, int E, int Ed, int F) {
  if (mode < nefes::SIGMA || mode > nefes::TRANSIENT) return -1;
#ifdef NEFES_EMULATE
  return 1;
#else
  using nefes::bwd_blocks_per_sm;
  using bf16 = __nv_bfloat16;
  const Dims d{depth, width, skipmask, E, Ed, F};
  if (dtype == 1)
    return raw ? bwd_blocks_per_sm<bf16, true>(d, mode) : bwd_blocks_per_sm<bf16, false>(d, mode);
  return raw ? bwd_blocks_per_sm<float, true>(d, mode) : bwd_blocks_per_sm<float, false>(d, mode);
#endif
}
