// Flash-attention forward for Hopper (sm_90a): bf16 in and out, products on
// the tensor cores (wgmma), tiles fed by the Tensor Memory Accelerator (TMA).
//
// Replaces: fedml_tpu/ops/attention.py::_flash_fwd_kernel (lines 59-106), the
// Pallas kernel launched by _flash_fwd (pallas_call at attention.py:124), for
// bf16 inputs; f32 inputs go to flash_fwd_f32_sm90.cu. Same
// function: o = softmax(q k^T * sm_scale) v over [B, H, T, D], an online
// softmax (running max m, sum l, accumulator o, all f32), the right-aligned
// causal mask (query i sees key j iff j <= i + (t_k - t_q)), key tiles past a
// query tile's last position not visited, masked probabilities forced to 0
// (m = -1e30 and l = 0 on a row that sees nothing), and o / max(l, 1e-20)
// rounded to bf16, so a fully masked row (t_q > t_k, causal) is exactly 0.
// sm_scale is applied to S in f32 after the product (q is not rounded after
// scaling). The one departure from the plain version: p is rounded to bf16 for
// the P.V product, as the JAX package's oracle attention_reference casts p to
// v's type; the sum l is kept in f32 from the unrounded p.
//
// What bounds it on the H100: at the main path's shape (B*H=128, T=1024,
// D=128, causal) the function moves 134 MB (~40 us at 3.35 TB/s) and needs
// 34 GFLOP of products (~35 us at the 989 TFLOP/s bf16 tensor-core peak):
// the two bounds are within 15% of each other, so the kernel has to keep the
// tensor cores fed and the loads of the next tile in flight while it computes.
// What holds this design back from that bound: one consumer warpgroup's
// softmax does not hide fully behind the other's products, and every query
// tile of a head reads the head's K and V again from L2 (1/128 of a byte per
// flop), which a K/V ring of fewer than three stages cannot cover.
//
// Design:
// - the work is B*H * ceil(Tq/128) query tiles of 128 rows, in an order that
//   walks groups of heads whose K and V fit in a third of the L2 cache
//   together, and within a group takes the last query tile of every head
//   first, then the one before: under the causal mask the tiles with the most
//   key tiles start first and the short ones fill the tail, and the heads in
//   flight reread their K and V from L2, not from device memory;
// - one persistent block per SM on a 1-D grid (B*H has no 65535 limit); a
//   block takes the next tile of that order from an atomic counter when its
//   producer has issued the last loads of its current one, so the blocks'
//   sums of key tiles come out even whatever the tiles' lengths;
// - three warpgroups per block. Warpgroups 0 and 1 consume, each owning 64 of
//   a tile's 128 query rows; warpgroup 2 produces: one of its threads issues
//   the TMA loads, each tile's Q once, then 128-key K and V tiles into a
//   three-stage ring guarded by full / empty mbarriers (K and V with a pair
//   each, so a K slot refills as soon as its Q K^T is done), so the next
//   tiles' loads, the next query tile's included, overlap this tile's
//   products and stores. setmaxnreg moves registers from the producer (24 a
//   thread) to the consumers (240 a thread);
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, K-major,
//   in the 128-byte swizzle the tensor maps write; f32 accumulators;
// - the softmax in registers: a row's 128 scores sit in the 4 threads of a
//   quad, the row max takes two xor shuffles, p = 2^(S*c - m*c) is one FMA
//   and one ex2 per score, masks are applied only on the tiles that cross the
//   diagonal or the key edge, and the partial sums l stay per thread and are
//   summed once at the end;
// - within a warpgroup, tile j+1's Q K^T and tile j's P V are issued together
//   and the softmax of tile j+1 runs while P V is still on the tensor cores
//   (FlashAttention-3's intra-warpgroup overlap); and the two consumer
//   warpgroups take turns to issue their products (two named barriers, as
//   FlashAttention-3's ping-pong schedule), so one's softmax runs while the
//   other's products keep the tensor cores busy;
// - O += P V: wgmma m64n{64,128}k16 with P rounded to bf16 in registers as
//   the A operand (the accumulator layout of S is the A-fragment layout) and
//   V from shared memory in MN-major (transposed) layout;
// - the tensor maps are 4-D over (D, T, H, B) with the inputs' own strides,
//   so q, k, v may be strided views (the heads of a fused qkv projection);
//   boxes are 64 columns (128 bytes) wide, and the maps' zero fill pads D to
//   64 or 128 and the ragged T edge without reading the next head. Keys past
//   Tk are masked, rows past Tq and columns past D are not stored.
// The tensor maps are encoded with cuTensorMapEncodeTiled from libcuda
// (linked with -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;          // keys per tile (the N of the Q K^T product)
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int PANEL = 64;        // bf16 columns in one 128-byte swizzled row
constexpr int NUM_THREADS = 384; // two consumer warpgroups and one producer
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----

// One box of a 4-D tensor map at (column, token, head, batch) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup's products are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product writes (accumulators) or reads (A fragments) across
// the wgmma_wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor for a tile written with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128B swizzle). Tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs),
// B from shared memory in MN-major (transposed) layout.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs),
// B from shared memory in MN-major (transposed) layout.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One tile's online-softmax step on this thread's two rows, in place: S (raw
// q.k) becomes p = 2^(S*c - m*c) with c = sm_scale*log2(e) and m the running
// row max of S; alpha is the factor for what was summed so far. MASK applies
// the causal and key-edge masks: a masked score becomes -inf, so its p is 0
// and it never raises m, and a row that sees nothing keeps m = -1e30, l = 0.
template <bool MASK>
__device__ __forceinline__ void softmax_step(float* s, float* m, float* l, float* alpha, int k0,
                                             int qpos, int col, int tk, int causal, float c) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * hh + e];
        if (MASK) {
          const int kpos = k0 + 8 * i + col + e;
          if (kpos >= tk || (causal && kpos > qpos + 8 * hh)) x = -CUDART_INF_F;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hh] = ex2((m[hh] - mx) * c);
    m[hh] = mx;
    const float mc = mx * c;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * hh + e];
        x = ex2(fmaf(x, c, -mc));
        sum += x;
      }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

// Barriers of a block in shared memory. The K and V tiles of each ring stage
// and the Q tile each have a "full" barrier (the producer's expect-tx arrival
// plus the TMA bytes) and an "empty" one (one arrival per consumer warp, once
// its products no longer read the tile). Query tiles reach the consumers
// through a two-slot ring of tile indices with the same pair of barriers.
struct Barriers {
  uint64_t full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];
  uint64_t q_full, q_empty, tile_full[2], tile_empty[2];
  int tile[2];
};

// Shared memory of a block for padded head dim DP: the Q tile, STAGES K and
// V tiles, each stored as DP/64 column panels of [rows][64] bf16 (128-byte
// swizzled rows), then the barriers; 1 KB of slack aligns the base.
constexpr size_t smem_bytes(int dp) {
  return 1024 + (size_t)2 * dp * (BQ + 2 * STAGES * BK) + sizeof(Barriers);
}

// Query tile `tile` of the order: heads are taken in groups of
// `heads_per_group`; within a group, the last query tile of every head first,
// then the one before, and so on.
struct Tile {
  int bh, q0, n_kt;
};

__device__ __forceinline__ Tile tile_of(int tile, int bh_total, int heads_per_group, int tq,
                                        int tk, int causal) {
  const int n_qt = (tq - 1) / BQ + 1;
  const int group = tile / (heads_per_group * n_qt);
  const int r = tile - group * heads_per_group * n_qt;
  const int heads = min(heads_per_group, bh_total - group * heads_per_group);
  Tile t;
  t.bh = group * heads_per_group + r % heads;
  t.q0 = (n_qt - 1 - r / heads) * BQ;
  t.n_kt = (tk - 1) / BK + 1;
  if (causal) {  // only key tiles at or before the tile's last query position
    const int last_q = tk - tq + min(t.q0 + BQ, tq) - 1;
    t.n_kt = last_q < 0 ? 0 : min(t.n_kt, last_q / BK + 1);
  }
  return t;
}

// One query tile for consumer warpgroup `wg` (64 of its rows): loop over key
// tiles, online softmax, write o. Thread (warp w, lane) holds rows
// 16w + lane/4 and that + 8 of the 64, and of each 8 columns the pair
// 2*(lane%4), +1 (the wgmma accumulator layout). Tile j+1's S = Q K^T and
// tile j's O += P V are issued together and the softmax of tile j+1 runs
// while P V is still on the tensor cores (FlashAttention-3's intra-warpgroup
// overlap). `it` counts the K/V tiles this block consumed before, for the
// ring's stage and phase; `local` counts its query tiles before this one.
// The two warpgroups take turns to issue products on named barriers 1 and 2
// (FlashAttention-3's ping-pong): each waits for its turn on barrier 1 + wg,
// which completes when the other has arrived there after its own issue; the
// turns alternate over the block's whole life, warpgroup 0 first.
template <int DP>
__device__ __forceinline__ void consume(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                        const __nv_bfloat16* vs, Barriers& bar,
                                        __nv_bfloat16* __restrict__ o, int wg, Tile t, int it,
                                        int local, bool& started, int tq, int tk, int d,
                                        float c, int causal) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row = wg * 64 + warp * 16 + lane / 4;  // in the query tile; +8 for the second
  const int col = 2 * (lane % 4);                  // within each group of 8 columns
  const int qpos = tk - tq + t.q0 + row;           // causal position of the first row
  const int q_lo = tk - tq + t.q0 + wg * 64;       // first query position of this warpgroup
  const int n_kt = t.n_kt;
  const __nv_bfloat16* q_wg = qs + wg * 64 * PANEL;

  float acc[DP / 2], s[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

  // S = Q K^T over DP/16 steps of 16 columns; a step moves 32 bytes along a
  // swizzled row (2 in the descriptor's 16-byte units)
  auto issue_qk = [&](int st) {
    const __nv_bfloat16* k_t = ks + st * BK * DP;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss_n128(s, sw128_desc(q_wg + p * BQ * PANEL, 16, 1024) + 2 * w,
                    sw128_desc(k_t + p * BK * PANEL, 16, 1024) + 2 * w, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V; V is MN-major: 8-key groups 1024 bytes apart (SBO), the
  // 64-column panels BK * 128 bytes apart (LBO)
  auto issue_pv = [&](int st) {
    const __nv_bfloat16* v_t = vs + st * BK * DP;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk], sw128_desc(v_t + kk * 16 * PANEL, BK * PANEL * 2, 1024));
    wgmma_commit();
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    if (k0 + BK > tk || (causal && k0 + BK - 1 > q_lo))
      softmax_step<true>(s, m, l, alpha, k0, qpos, col, tk, causal, c);
    else
      softmax_step<false>(s, m, l, alpha, k0, qpos, col, tk, causal, c);
  };
  auto to_bf16 = [&]() {  // P as the A fragments of BK/16 products of 16 keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  auto release = [&](uint64_t* b) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };
  auto stage = [&](int kt) { return (it + kt) % STAGES; };
  auto parity = [&](int kt) { return (uint32_t)((it + kt) / STAGES) & 1; };
  auto my_turn = [&]() {
    if (!started && wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    started = true;
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };

  mbar_wait(&bar.q_full, local & 1);
  if (n_kt == 0) release(&bar.q_empty);
  if (n_kt > 0) {
    mbar_wait(&bar.full_k[stage(0)], parity(0));
    my_turn();
    wgmma_fence();
    issue_qk(stage(0));
    your_turn();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    release(&bar.empty_k[stage(0)]);
    if (n_kt == 1) release(&bar.q_empty);
    softmax(0);
    to_bf16();
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    mbar_wait(&bar.full_k[stage(kt)], parity(kt));
    mbar_wait(&bar.full_v[stage(kt - 1)], parity(kt - 1));
    fence_regs<DP / 2>(acc);
    my_turn();
    wgmma_fence();
    issue_qk(stage(kt));
    issue_pv(stage(kt - 1));
    your_turn();
    wgmma_wait<1>();  // S of tile kt is ready; P.V of tile kt-1 still runs
    fence_regs<BK / 2>(s);
    release(&bar.empty_k[stage(kt)]);
    if (kt == n_kt - 1) release(&bar.q_empty);
    softmax(kt);
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    fence_regs<BK / 4>(&pa[0][0]);
    release(&bar.empty_v[stage(kt - 1)]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    to_bf16();
  }
  if (n_kt > 0) {
    mbar_wait(&bar.full_v[stage(n_kt - 1)], parity(n_kt - 1));
    fence_regs<DP / 2>(acc);
    my_turn();
    wgmma_fence();
    issue_pv(stage(n_kt - 1));
    your_turn();
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    fence_regs<BK / 4>(&pa[0][0]);
    release(&bar.empty_v[stage(n_kt - 1)]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  __nv_bfloat16* ob = o + (size_t)t.bh * tq * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = t.q0 + row + 8 * hh;
    if (r >= tq) continue;
    const float den = fmaxf(l[hh], 1e-20f);
    __nv_bfloat16* orow = ob + (size_t)r * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int cc = 8 * j + col;
      if (cc < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + cc) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / den, acc[4 * j + 2 * hh + 1] / den);
    }
  }
}

// A persistent block: it takes query tile blockIdx.x of the order first,
// then whichever tile is next when its producer has issued the last loads of
// the current one (`*next_tile` counts the tiles taken after the first
// gridDim.x). The producer's ring runs on across tiles, so the next tile's Q
// and first K/V tiles load while this tile's last products and stores run.
template <int DP>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                      int* __restrict__ next_tile, int n_tiles, int bh_total, int h, int heads_per_group, int tq, int tk,
                      int d, float scale_log2, int causal) {
  constexpr int NP = DP / PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);  // [NP][BQ][64]
  __nv_bfloat16* ks = qs + BQ * DP;                             // [STAGES][NP][BK][64]
  __nv_bfloat16* vs = ks + STAGES * BK * DP;                    // [STAGES][NP][BK][64]
  Barriers& bar = *reinterpret_cast<Barriers*>(vs + STAGES * BK * DP);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.full_k[i], 1);
      mbar_init(&bar.full_v[i], 1);
      mbar_init(&bar.empty_k[i], CONSUMER_WARPS);
      mbar_init(&bar.empty_v[i], CONSUMER_WARPS);
    }
    mbar_init(&bar.q_full, 1);
    mbar_init(&bar.q_empty, CONSUMER_WARPS);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar.tile_full[i], 1);
      mbar_init(&bar.tile_empty[i], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int it = 0, local = 0;
      for (int tile = blockIdx.x;; tile = gridDim.x + atomicAdd(next_tile, 1)) {
        // hand the tile index (-1: no more) to the consumers
        const int slot = local & 1;
        mbar_wait(&bar.tile_empty[slot], ((local >> 1) & 1) ^ 1);
        bar.tile[slot] = tile < n_tiles ? tile : -1;
        mbar_arrive(&bar.tile_full[slot]);
        if (tile >= n_tiles) break;
        const Tile t = tile_of(tile, bh_total, heads_per_group, tq, tk, causal);
        const int bi = t.bh / h, hi = t.bh - bi * h;
        mbar_wait(&bar.q_empty, (local & 1) ^ 1);
        mbar_expect_tx(&bar.q_full, 2 * BQ * DP);
        for (int p = 0; p < NP; ++p)
          tma_load(qs + p * BQ * PANEL, &map_q, &bar.q_full, p * PANEL, t.q0, hi, bi);
        for (int kt = 0; kt < t.n_kt; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&bar.empty_k[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&bar.full_k[st], 2 * BK * DP);
          for (int p = 0; p < NP; ++p)
            tma_load(ks + (st * NP + p) * BK * PANEL, &map_k, &bar.full_k[st], p * PANEL,
                     kt * BK, hi, bi);
          mbar_wait(&bar.empty_v[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&bar.full_v[st], 2 * BK * DP);
          for (int p = 0; p < NP; ++p)
            tma_load(vs + (st * NP + p) * BK * PANEL, &map_v, &bar.full_v[st], p * PANEL,
                     kt * BK, hi, bi);
        }
        ++local;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    int it = 0, local = 0;
    bool started = false;  // has this warpgroup taken a turn to issue products
    for (;; ++local) {
      const int slot = local & 1;
      mbar_wait(&bar.tile_full[slot], (local >> 1) & 1);
      const int tile = bar.tile[slot];
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&bar.tile_empty[slot]);
      if (tile < 0) break;
      const Tile t = tile_of(tile, bh_total, heads_per_group, tq, tk, causal);
      consume<DP>(qs, ks, vs, bar, o, wg, t, it, local, started, tq, tk, d, scale_log2, causal);
      it += t.n_kt;
    }
    // warpgroup 1 arrived on barrier 1 after its last turn: take it up
    if (started && wg == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
}

// A 4-D map over (D, T, H, B) of a bf16 [B, H, T, D] view with element
// strides sb, sh, st (unit stride along D); boxes of 64 columns x `rows`.
CUresult make_map(CUtensorMap* map, const void* ptr, int b, int h, int t, int d, long long sb,
                  long long sh, long long st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {PANEL, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                   void* next_tile, int b, int h, int tq, int tk, int d, float sm_scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int bh = b * h, n_tiles = bh * ((tq - 1) / BQ + 1);
  // heads whose K and V (padded to DP columns) fill at most 16 MB of the 50 MB
  // L2, so that two groups in flight at a group boundary still fit
  const long long kv_bytes = 4LL * DP * (((long long)tk + BK - 1) / BK * BK);
  const int group = (int)(kv_bytes >= (16LL << 20) ? 1 : ((16LL << 20) / kv_bytes));
  const int heads_per_group = group < bh ? group : bh;
  const int blocks = n_tiles < sms ? n_tiles : sms;
  flash_fwd_sm90_kernel<DP><<<blocks, NUM_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<int*>(next_tile), n_tiles, bh, h, heads_per_group, tq, tk, d,
      sm_scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, tq, D], k/v [B, H, tk, D]: bf16 views with element strides
// (batch, head, token) given per operand and unit stride along D; 16-byte
// aligned bases and strides that are multiples of 8 elements (TMA's rules).
// o: a contiguous bf16 [B, H, tq, D]. next_tile: one int, 0 at the launch,
// which the blocks count up as they take tiles. D a multiple of 8 up to 128.
// Launches on
// `stream` and returns 0, a cudaError_t of the launch, or 10000 + the CUresult
// of a refused tensor map.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                              void* next_tile, int b, int h,
                              int tq, int tk, int d, long long q_sb, long long q_sh,
                              long long q_st, long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st, float sm_scale,
                              int causal, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 ||
      (long long)b * h * ((tq - 1) / BQ + 1) > 0x7fffffffLL || d < 8 || d > 128 || d % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  CUresult res = make_map(&mq, q, b, h, tq, d, q_sb, q_sh, q_st, BQ);
  if (res == CUDA_SUCCESS) res = make_map(&mk, k, b, h, tk, d, k_sb, k_sh, k_st, BK);
  if (res == CUDA_SUCCESS) res = make_map(&mv, v, b, h, tk, d, v_sb, v_sh, v_st, BK);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d <= 64 ? launch<64>(mq, mk, mv, o, next_tile, b, h, tq, tk, d, sm_scale, causal, s)
              : launch<128>(mq, mk, mv, o, next_tile, b, h, tq, tk, d, sm_scale, causal, s);
  return (int)err;
}
