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
// Bound on an H100: K9, K10 and K12 by operations (0.25 MFLOP a row for
// K9, 2 x 8 x W^2 a row for K12, against a few hundred bytes a row); K11
// by bytes (12 in and 128 out a row, beside 30 sin/cos pairs).
//
// The chain (bf16, sm_90a), one design for K9, K10 and K12:
//
// - A CTA is two consumer warpgroups and one producer warpgroup (384
//   threads, one CTA an SM). Each consumer warpgroup holds MT 64-row m-tiles; a
//   "pass" is the CTA's 2 x MT m-tiles meeting one stream of every weight
//   slice of every layer.
// - Products are wgmma.mma_async m64nWk16 (bf16 in, f32 accumulate), A from
//   registers, B from shared memory. A consumer thread keeps its m-tiles'
//   64 x W f32 accumulators in registers; after a layer it rounds them to
//   bf16 through the ReLU and repacks them in place as the next layer's A
//   fragments: the accumulator of columns 16k..16k+15 is, thread by
//   thread, the A fragment of k-step k. With two m-tiles a warpgroup,
//   each m-tile's products are a wgmma group of their own, so one m-tile
//   converts while the other's products run. Only layer 0's input (x, read
//   from shared memory) and the last layer's output (16-byte stores from
//   registers) leave the registers.
// - Weights are streamed, not resident (K9's 240 KB and K12's 1 MB at W =
//   256 do not fit 227 KB). pack_chain (kernels/micro.py) lays them out
//   once on the host in the kernel's order: per layer, K-slices of 64 k by
//   W outputs, each the canonical K-major 128-byte-swizzled B operand (row
//   n of a slice is 64 k values, 16-byte chunk q stored at chunk q ^ (n &
//   7); chain_w_index), 16 KB at W = 128, 32 KB at W = 256. The producer
//   warp's one thread copies the slices in order with cp.async.bulk into
//   a ring of shared-memory stages under full and empty mbarriers (8
//   stages at W = 128, 4 at W = 256), one stream a pass; the x m-tiles of
//   the next pass by cp.async.bulk into their own buffer (rows of a
//   m-tile are contiguous), issued once the consumers have begun this
//   pass. The last layer's output columns are permuted in the blob
//   (chain_out_col) so that each thread's accumulator holds 8 consecutive
//   output columns: one 16-byte store a row a 32-column group.
// - MT and nb: nb (K10) is the m-tiles in flight against each weight
//   slice. nb = 2: one m-tile a warpgroup (128 rows a pass). nb = 4: two
//   a warpgroup (256 rows a pass; W = 128 only: 2 x (64 + 32) accumulator
//   and A registers). nb = 1 (K9, K12) takes the most the registers hold:
//   two a warpgroup at W = 128, one at W = 256 (128 + 64 registers). So K9
//   runs K10 x4's schedule; K10 x2 shows what halving the rows a pass
//   costs. Every row's products are the same instructions in the same
//   order whatever its m-tile, so K10's values are K9's bit for bit.
// - Registers: a 384-thread CTA leaves 168 a thread (3 warps on each SM
//   sub-partition's 16 K registers), too few for two m-tiles at W = 128
//   or one at W = 256 (192 accumulator and A registers: ptxas spilled and
//   serialised the wgmma). setmaxnreg gives the producer warpgroup 40 and
//   the consumers 232.
// - A persistent grid walks units of `tile` rows (the JAX grid step): the
//   lesser of the unit count and the resident CTAs (one an SM), CTA c
//   taking units c, c + G, ...; its units' m-tiles in order make its
//   passes (a pass may span units at tile 64 and a unit several passes
//   above). At tile 8192 there are 75 units for 132 SMs: 57 SMs idle.
// - The weights are re-read from L2 once a pass: 240 KB (K9) for 256 rows
//   at nb = 4, 1 MB for 128 rows at W = 256.
//
// The embedding (K11): a persistent grid of 256-thread CTAs over units of
// `tile` rows, each unit split in halves while there are fewer than 4
// pieces a resident CTA (tile 8192 would leave 57 SMs idle), CTA c taking
// pieces c, c + G, ... One thread computes a whole row: the exact f32
// phases x * 2^k (the plain version's multiply) and one full-precision
// sincosf a phase, whose argument reduction holds at the hundreds of
// radians the top band reaches (the __sinf intrinsic does not); its bits
// are sinf's and cosf's, in less time than the two (0.0408 against 0.0550
// ms at tile 512 on an H100, in turns; PERF.md). It packs
// the row's bf16 pairs into eight 16-byte chunks in shared memory, and
// the CTA then writes its rows out as consecutive 16-byte stores. One
// integer divide a row (its piece), none an element.
//
// Host build (NEFES_EMULATE, one thread a CTA): the chain in f32 walks the
// same units and passes and reads the same packed blob through
// chain_w_index and chain_out_col, so the CPU tests check the packing and
// the walk; the embedding runs its own source in f32. The card runs bf16
// only (each build refuses the other dtype); what only the card shows
// (fragment layouts, the swizzle, the barriers) chip_smoke.py's micro
// phase checks.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "tower.cuh"

namespace nefes {

constexpr int EMBED_BANDS = 10;   // 2^0 .. 2^9
constexpr int EMBED_COLS = 64;    // 30 sines, 30 cosines, 4 zero columns
constexpr int EMBED_THREADS = 256;
constexpr int CHAIN_KS = 64;      // k values of a weight slice: 128 bytes of bf16
constexpr int CHAIN_WGS = 2;      // consumer warpgroups a CTA
constexpr int CHAIN_THREADS = (CHAIN_WGS + 1) * 128;   // and the producer warpgroup
constexpr int CHAIN_REGS_PRODUCER = 40, CHAIN_REGS_CONSUMER = 232;   // setmaxnreg
constexpr int EMU_SMS = 3;        // the host build's resident CTAs

// The shapes the chain takes, the probe's: E = W = 128 or 256, or E = 64
// and W = 128; nb 1, 2 or (W = 128) 4.
__host__ __device__ inline bool chain_shape_ok(int nb, int E, int W) {
  return (W == 128 || W == 256) && (E == W || (E == 64 && W == 128)) &&
         (nb == 1 || nb == 2 || (nb == 4 && W == 128));
}

// 64-row m-tiles a consumer warpgroup holds against each weight slice.
__host__ __device__ constexpr int chain_mt(int nb, int W) { return nb == 2 || W > 128 ? 1 : 2; }

__host__ __device__ constexpr int chain_stages(int W) { return W > 128 ? 4 : 8; }

// Element of the packed blob that holds layer l's weight of input k for
// accumulator position p (its output column, chain_out_col(p) in the last
// layer): K-slices of CHAIN_KS x W, each row p of a slice 8 chunks of 8 k
// values, chunk q at q ^ (p & 7).
__host__ __device__ inline size_t chain_w_index(int E, int W, int l, int k, int p) {
  const size_t base = l == 0 ? 0 : (size_t)E * W + (size_t)(l - 1) * W * W;
  const int s = k / CHAIN_KS, kk = k - s * CHAIN_KS;
  return base + ((size_t)s * W + p) * CHAIN_KS + ((((kk >> 3) ^ p) & 7) << 3) + (kk & 7);
}

// The last layer's output column at accumulator position p = 32 q + 8 jj +
// 2 t + e (n8 block 4 q + jj, thread t of a quad): 32 q + 8 t + 2 jj + e,
// so thread t holds columns 32 q + 8 t .. + 7. Its own inverse.
__host__ __device__ constexpr int chain_out_col(int p) {
  return (p & ~31) | ((p & 6) << 2) | ((p >> 2) & 6) | (p & 1);
}

// The persistent walk: CTA c of G takes units c, c + G, ... of `tile`
// rows; chain_mtiles is its m-tile count, chain_mtile_row the first row of
// its i-th m-tile.
__host__ __device__ inline int chain_mtiles(int c, int G, int units, int tile) {
  return (units - c + G - 1) / G * (tile / TR);
}

__host__ __device__ inline size_t chain_mtile_row(int c, int G, int tile, int i) {
  const int per = tile / TR, j = i / per;
  return (size_t)(c + j * G) * tile + (size_t)(i - j * per) * TR;
}

// Dynamic shared memory of a chain CTA: 1024 bytes of alignment slack,
// the weight stages, the x m-tiles of a pass and the mbarriers.
inline size_t chain_smem(int nb, int E, int W) {
  return 1024 + (size_t)chain_stages(W) * W * CHAIN_KS * 2 +
         (size_t)CHAIN_WGS * chain_mt(nb, W) * TR * E * 2 + (2 * chain_stages(W) + 2) * 8;
}

// The embedding's piece: `tile` halved while the pieces number fewer than
// 4 a resident CTA and the piece has an even number of rows.
inline int embed_piece_rows(int units, int tile, int resident) {
  int rows = tile;
  while (rows % 2 == 0 && (long long)units * (tile / rows) < 4LL * resident) rows /= 2;
  return rows;
}

struct Chunk16 {
  uint32_t v[4];
};

#ifndef NEFES_EMULATE

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of bar with the given parity to complete. A wait
// longer than ~5 s (10^10 clocks) can only be a fault in the barriers'
// bookkeeping: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > 10000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the fences
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a weight slice in shared memory (1024-byte aligned):
// K-major, 128-byte swizzle, 8-row groups 1024 bytes apart. A k-step of 16
// adds 32 bytes to the start address (2 in its 16-byte units).
__device__ __forceinline__ uint64_t slice_desc(const void* slice) {
  return (uint64_t)((smem_u32(slice) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// wgmma m64nNk16, f32 += bf16 A (registers) x bf16 B (descriptor);
// scale_d 0 overwrites the accumulator.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  return pack_bf16x2(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
}

// One layer of K inputs for the warpgroup's MT m-tiles: K / 64 weight
// slices from the ring, one wgmma group a slice and m-tile. In a layer
// after the first, m-tile i's input is its accumulator of the layer
// before, rounded through the ReLU into A fragments once that m-tile's
// last group has completed (wait_group MT - 1: m-tile 1's products run
// while m-tile 0 converts). A slice goes back to the producer once its
// groups have completed.
template <int K, int W, int MT, bool FIRST>
__device__ __forceinline__ void chain_layer(uint32_t (&a)[MT][W / 16][4],
                                            float (&acc)[MT][W / 2], char* stages,
                                            uint64_t* full, uint64_t* empty, int& q_all,
                                            int& prev, int lane) {
  constexpr int S = chain_stages(W);
#pragma unroll
  for (int sl = 0; sl < K / CHAIN_KS; ++sl) {
    const int s = q_all % S;
    mbar_wait(&full[s], (q_all / S) & 1);
    const uint64_t desc = slice_desc(stages + s * (W * CHAIN_KS * 2));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      reg_fence(acc[i]);
      if (!FIRST && sl == 0) {
        wgmma_wait<MT - 1>();
        reg_fence(acc[i]);
        if (i == MT - 1 && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int ks = 0; ks < W / 16; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[i][ks][j] = relu_bf16x2(acc[i][8 * ks + 2 * j], acc[i][8 * ks + 2 * j + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHAIN_KS / 16; ++kk)
        Wgmma<W>::mma(acc[i], a[i][sl * (CHAIN_KS / 16) + kk], desc + 2 * kk, sl + kk);
      wgmma_commit();
    }
    if (sl > 0) {
      wgmma_wait<MT>();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
    ++q_all;
  }
}

template <int E, int W, int MT>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
chain_kernel(int units, int tile, int D, const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out) {
  constexpr int S = chain_stages(W), SLICE = W * CHAIN_KS * 2, XT = TR * E * 2;
  constexpr int MTILES = CHAIN_WGS * MT;
  extern __shared__ __align__(16) char chain_smem_raw[];
  char* stages = chain_smem_raw + ((1024 - (smem_u32(chain_smem_raw) & 1023)) & 1023);
  char* xbuf = stages + S * SLICE;
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + MTILES * XT);
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;
  uint64_t* xempty = xfull + 1;
  const int c = blockIdx.x, G = gridDim.x;
  const int mc = chain_mtiles(c, G, units, tile), passes = (mc + MTILES - 1) / MTILES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CHAIN_WGS * 4);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, CHAIN_WGS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CHAIN_WGS * 4) {   // the producer warpgroup: one thread streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(CHAIN_REGS_PRODUCER));
    if (warp != CHAIN_WGS * 4 || lane != 0) return;
    const int Q = E / CHAIN_KS + (D - 1) * (W / CHAIN_KS);   // slices a pass
    auto load_x = [&](int p) {
      const int first = p * MTILES, cnt = mc - first < MTILES ? mc - first : MTILES;
      mbar_wait(xempty, (p & 1) ^ 1);
      mbar_expect_tx(xfull, cnt * XT);
      for (int i = 0; i < cnt; ++i)
        bulk_load(xbuf + i * XT, x + chain_mtile_row(c, G, tile, first + i) * E, XT, xfull);
    };
    load_x(0);
    // the next pass's x once the consumers have begun this one: the empty
    // barrier of this pass's slice S is released by their slice 0
    const int x_at = Q > S ? S : Q - 1;
    int q_all = 0;
    for (int p = 0; p < passes; ++p) {
      for (int q = 0; q < Q; ++q, ++q_all) {
        const int s = q_all % S;
        mbar_wait(&empty[s], ((q_all / S) & 1) ^ 1);
        if (q == x_at && p + 1 < passes) load_x(p + 1);
        mbar_expect_tx(&full[s], SLICE);
        bulk_load(stages + s * SLICE, w + (size_t)q * W * CHAIN_KS, SLICE, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 16 wl + g and + 8 of each of its m-tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CHAIN_REGS_CONSUMER));
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  uint32_t a[MT][W / 16][4];
  float acc[MT][W / 2];
  int q_all = 0;
  for (int p = 0; p < passes; ++p) {
    mbar_wait(xfull, p & 1);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const char* xt = xbuf + (wg * MT + i) * XT + ((16 * wl + g) * E + 2 * t) * 2;
#pragma unroll
      for (int ks = 0; ks < E / 16; ++ks) {
        const char* p0 = xt + ks * 32;
        a[i][ks][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[i][ks][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * E * 2);
        a[i][ks][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        a[i][ks][3] = *reinterpret_cast<const uint32_t*>(p0 + 8 * E * 2 + 16);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty);
    int prev = 0;   // the stage of the slice last issued
    chain_layer<E, W, MT, true>(a, acc, stages, full, empty, q_all, prev, lane);
    for (int l = 1; l < D; ++l)
      chain_layer<W, W, MT, false>(a, acc, stages, full, empty, q_all, prev, lane);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) reg_fence(acc[i]);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mi = p * MTILES + wg * MT + i;
      if (mi >= mc) continue;
      __nv_bfloat16* o0 =
          out + (chain_mtile_row(c, G, tile, mi) + 16 * wl + g) * W + 8 * t;
      __nv_bfloat16* o1 = o0 + 8 * W;
#pragma unroll
      for (int q = 0; q < W / 32; ++q) {
        const int b = 16 * q;
        *reinterpret_cast<uint4*>(o0 + 32 * q) = make_uint4(
            relu_bf16x2(acc[i][b], acc[i][b + 1]), relu_bf16x2(acc[i][b + 4], acc[i][b + 5]),
            relu_bf16x2(acc[i][b + 8], acc[i][b + 9]),
            relu_bf16x2(acc[i][b + 12], acc[i][b + 13]));
        *reinterpret_cast<uint4*>(o1 + 32 * q) = make_uint4(
            relu_bf16x2(acc[i][b + 2], acc[i][b + 3]), relu_bf16x2(acc[i][b + 6], acc[i][b + 7]),
            relu_bf16x2(acc[i][b + 10], acc[i][b + 11]),
            relu_bf16x2(acc[i][b + 14], acc[i][b + 15]));
      }
    }
  }
}

using ChainKern = void (*)(int, int, int, const __nv_bfloat16*, const __nv_bfloat16*,
                           __nv_bfloat16*);

inline ChainKern chain_kern(int nb, int E, int W) {
  const bool two = chain_mt(nb, W) == 2;
  if (E == 64) return two ? &chain_kernel<64, 128, 2> : &chain_kernel<64, 128, 1>;
  if (W == 128) return two ? &chain_kernel<128, 128, 2> : &chain_kernel<128, 128, 1>;
  return &chain_kernel<256, 256, 1>;
}

__device__ __forceinline__ void store16(void* dst, const Chunk16& c) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(c.v[0], c.v[1], c.v[2], c.v[3]);
}

using MicroT = __nv_bfloat16;   // the card's dtype
#endif  // !NEFES_EMULATE

// Resident CTAs of a kernel on the current card (SMs x CTAs an SM), its
// dynamic shared memory allowed first; the host build's EMU_SMS. Negative
// on a CUDA error. Kept per kernel and card after the first query, so that
// a launch costs the host no CUDA queries.
template <typename K>
inline int resident_ctas(K kern, int threads, size_t smem) {
#ifdef NEFES_EMULATE
  (void)kern, (void)threads, (void)smem;
  return EMU_SMS;
#else
  struct Entry {
    const void* kern;
    int dev, ctas;
  };
  static Entry known[64];
  static int n_known = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kern == (const void*)kern && known[i].dev == dev) return known[i].ctas;
  int sms = 0, per = 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (n_known < 64) known[n_known++] = Entry{(const void*)kern, dev, sms * per};
  return sms * per;
#endif
}

#ifdef NEFES_EMULATE
// The host build's chain in f32: one thread walks the CTA's passes, each
// m-tile of a pass through every layer, reading the packed blob.
inline void chain_kernel_host(int units, int tile, int nb, int E, int W, int D,
                              const float* x, const float* w, float* out) {
  const int c = blockIdx.x, G = gridDim.x, mtiles = CHAIN_WGS * chain_mt(nb, W);
  const int mc = chain_mtiles(c, G, units, tile), passes = (mc + mtiles - 1) / mtiles;
  float* h = reinterpret_cast<float*>(nefes_smem);   // two TR x 256 buffers
  float* o = h + TR * 256;
  for (int p = 0; p < passes; ++p)
    for (int j = 0; j < mtiles; ++j) {
      const int mi = p * mtiles + j;
      if (mi >= mc) continue;
      const size_t row0 = chain_mtile_row(c, G, tile, mi);
      for (int e = 0; e < TR * E; ++e) h[e] = x[row0 * E + e];
      for (int l = 0; l < D; ++l) {
        const int K = l ? W : E;
        for (int r = 0; r < TR; ++r)
          for (int q = 0; q < W; ++q) {
            float s = 0.f;
            for (int k = 0; k < K; ++k) s += h[r * K + k] * w[chain_w_index(E, W, l, k, q)];
            o[r * W + q] = fmaxf(s, 0.f);
          }
        float* tmp = h;
        h = o;
        o = tmp;
      }
      for (int r = 0; r < TR; ++r)
        for (int q = 0; q < W; ++q) out[(row0 + r) * W + chain_out_col(q)] = h[r * W + q];
    }
}

inline void store16(void* dst, const Chunk16& c) { memcpy(dst, c.v, 16); }

using MicroT = float;   // the host build's dtype
#endif

// One row of the embedding, as 16-byte chunks of T: [sin(xs), cos(xs), 0 x
// 4] with xs = [x * 2^0, ..., x * 2^9] band-major (column 3 k + j holds
// coordinate j of band k). f32 (the host build):
template <typename T>
__device__ __forceinline__ void embed_row(const float* __restrict__ xr, Chunk16* ch) {
  float v[EMBED_COLS];
  const float x3[3] = {xr[0], xr[1], xr[2]};
#pragma unroll
  for (int k = 0; k < EMBED_BANDS; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sincosf(x3[j] * (float)(1 << k), &v[3 * k + j], &v[3 * EMBED_BANDS + 3 * k + j]);
#pragma unroll
  for (int c = 6 * EMBED_BANDS; c < EMBED_COLS; ++c) v[c] = 0.f;
#pragma unroll
  for (int q = 0; q < EMBED_COLS / 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) memcpy(&ch[q].v[i], &v[4 * q + i], 4);
}

#ifndef NEFES_EMULATE
// bf16: phases 2 i and 2 i + 1 give word i (their sines) and word 15 + i
// (their cosines) of the row, packed as they are computed.
template <>
__device__ __forceinline__ void embed_row<__nv_bfloat16>(const float* __restrict__ xr,
                                                         Chunk16* ch) {
  const float x3[3] = {xr[0], xr[1], xr[2]};
  uint32_t wd[EMBED_COLS / 2];
#pragma unroll
  for (int i = 0; i < 3 * EMBED_BANDS / 2; ++i) {
    const float p0 = x3[(2 * i) % 3] * (float)(1 << (2 * i / 3));
    const float p1 = x3[(2 * i + 1) % 3] * (float)(1 << ((2 * i + 1) / 3));
    float s0, c0, s1, c1;
    sincosf(p0, &s0, &c0);
    sincosf(p1, &s1, &c1);
    wd[i] = pack_bf16x2(s0, s1);
    wd[3 * EMBED_BANDS / 2 + i] = pack_bf16x2(c0, c1);
  }
  wd[EMBED_COLS / 2 - 2] = wd[EMBED_COLS / 2 - 1] = 0u;
#pragma unroll
  for (int q = 0; q < EMBED_COLS / 8; ++q)
    ch[q] = Chunk16{{wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]}};
}
#endif

// pts (n, 3) f32 -> out (n, 64) in T. CTA c takes pieces c, c + G, ... of
// piece_rows rows; its threads take its rows in order, one a thread, then
// write them out as 16-byte chunks.
template <typename T>
__global__ void __launch_bounds__(EMBED_THREADS)
embed_kernel(int pieces, int piece_rows, const float* __restrict__ pts, T* __restrict__ out) {
  constexpr int RC = EMBED_COLS * (int)sizeof(T) / 16;   // 16-byte chunks a row
  __shared__ Chunk16 stage[EMBED_THREADS][RC + 1];       // + 1: no bank conflicts
  __shared__ int srow[EMBED_THREADS];
  const int c = blockIdx.x, G = gridDim.x, nt = blockDim.x, tid = threadIdx.x;
  const int rows = (pieces - c + G - 1) / G * piece_rows;
  for (int r0 = 0; r0 < rows; r0 += nt) {
    const int s = r0 + tid;
    if (s < rows) {
      const int j = s / piece_rows;
      const int row = (c + j * G) * piece_rows + (s - j * piece_rows);
      srow[tid] = row;
      embed_row<T>(pts + (size_t)row * 3, stage[tid]);
    }
    __syncthreads();
    const int here = rows - r0 < nt ? rows - r0 : nt;
    for (int i = tid; i < here * RC; i += nt)
      store16(out + (size_t)srow[i / RC] * EMBED_COLS + (i % RC) * (16 / (int)sizeof(T)),
              stage[i / RC][i % RC]);
    __syncthreads();
  }
}

// The embedding's launch: (grid, piece rows) for n rows in units of tile.
template <typename T>
inline int embed_grid(int n, int tile, int* piece_rows) {
  const int resident = resident_ctas(&embed_kernel<T>, EMBED_THREADS, 0);
  if (resident <= 0) return resident < 0 ? resident : -5;
  *piece_rows = embed_piece_rows(n / tile, tile, resident);
  const int pieces = n / *piece_rows;
  return pieces < resident ? pieces : resident;
}

}  // namespace nefes

// The dtype each build takes: bf16 on the card (tensor cores), f32 in the
// host build.
static constexpr int MICRO_DTYPE = std::is_same<nefes::MicroT, float>::value ? 0 : 1;

// The chain's launch: its CTAs (the lesser of the units and the resident
// CTAs) for n rows in units of tile; -1 for the other build's dtype, -4
// for a shape the kernel does not take, another negative number for a
// CUDA error.
extern "C" int nefes_micro_chain_grid(int dtype, int n, int tile, int nb, int E, int W) {
  if (dtype != MICRO_DTYPE) return -1;
  if (!nefes::chain_shape_ok(nb, E, W)) return -4;
  if (n < 1 || tile < nefes::TR || tile % nefes::TR || n % tile) return -4;
  const size_t smem = nefes::chain_smem(nb, E, W);
#ifdef NEFES_EMULATE
  const int resident = nefes::resident_ctas(0, nefes::CHAIN_THREADS, smem);
#else
  const int resident =
      nefes::resident_ctas(nefes::chain_kern(nb, E, W), nefes::CHAIN_THREADS, smem);
#endif
  if (resident <= 0) return resident < 0 ? resident : -5;
  return n / tile < resident ? n / tile : resident;
}

// Dynamic shared memory of a chain CTA (bytes), -4 for a shape it does not
// take.
extern "C" int nefes_micro_chain_smem(int nb, int E, int W) {
  return nefes::chain_shape_ok(nb, E, W) ? (int)nefes::chain_smem(nb, E, W) : -4;
}

// dtype: 0 = float32 (host build), 1 = bfloat16 (the card), for x, w and
// out. nb: the m-tiles in flight against each weight slice (1: K9 and K12,
// the most the registers hold; 2 or 4: K10). w: pack_chain's blob. n must
// be a multiple of tile and tile of 64; -1 for the other build's dtype,
// -4 for such a shape, before any pointer is read.
extern "C" int nefes_micro_chain(int dtype, int n, int tile, int nb, int E, int W, int D,
                                 const void* x, const void* w, void* out, void* stream) {
  if (dtype != MICRO_DTYPE) return -1;
  if (D < 1) return -4;
  const int grid = nefes_micro_chain_grid(dtype, n, tile, nb, E, W);
  if (grid <= 0) return grid;
#ifdef NEFES_EMULATE
  (void)stream;
  NEFES_LAUNCH(nefes::chain_kernel_host, grid, 0, stream, n / tile, tile, nb, E, W, D,
               static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<float*>(out));
#else
  nefes::chain_kern(nb, E, W)<<<grid, nefes::CHAIN_THREADS, nefes::chain_smem(nb, E, W),
                                static_cast<cudaStream_t>(stream)>>>(
      n / tile, tile, D, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out));
#endif
  return (int)cudaGetLastError();
}

// The embedding's CTAs for n rows in units of tile, its piece's rows in
// *piece_rows (may be null); -1 / -4 as the chain's.
extern "C" int nefes_micro_embed_grid(int dtype, int n, int tile, int* piece_rows) {
  if (dtype != MICRO_DTYPE) return -1;
  if (n < 1 || tile < 1 || n % tile) return -4;
  int rows = 0;
  const int grid = nefes::embed_grid<nefes::MicroT>(n, tile, &rows);
  if (piece_rows) *piece_rows = rows;
  return grid;
}

// pts (n, 3) f32 -> out (n, 64) in dtype; n a multiple of tile.
extern "C" int nefes_micro_embed(int dtype, int n, int tile, const float* pts, void* out,
                                 void* stream) {
  int rows = 0;
  const int grid = nefes_micro_embed_grid(dtype, n, tile, &rows);
  if (grid <= 0) return grid;
#ifdef NEFES_EMULATE
  (void)stream;
  auto* kern = &nefes::embed_kernel<float>;
  NEFES_LAUNCH(kern, grid, 0, stream, n / rows, rows, pts, static_cast<float*>(out));
#else
  nefes::embed_kernel<__nv_bfloat16><<<grid, nefes::EMBED_THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      n / rows, rows, pts, static_cast<__nv_bfloat16*>(out));
#endif
  return (int)cudaGetLastError();
}

// Streaming multiprocessors of the current card (the host build's EMU_SMS).
extern "C" int nefes_micro_sms() {
#ifdef NEFES_EMULATE
  return nefes::EMU_SMS;
#else
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
#endif
}
