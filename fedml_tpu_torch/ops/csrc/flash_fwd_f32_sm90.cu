// Flash-attention forward for Hopper (sm_90a): f32 in and out, products on
// the TF32 tensor cores in three passes (3xTF32), which hold f32 accuracy.
//
// Replaces: fedml_tpu/ops/attention.py::_flash_fwd_kernel (lines 59-106), the
// Pallas kernel launched by _flash_fwd (pallas_call at attention.py:124), for
// f32 inputs; bf16 inputs go to flash_fwd_sm90.cu. Same function:
// o = softmax(q k^T * sm_scale) v over [B, H, T, D], q scaled by sm_scale in
// f32 before the product, an online softmax (running max m, sum l,
// accumulator o, all f32), the right-aligned causal mask (query i sees key j
// iff j <= i + (t_k - t_q)), key tiles past a query tile's last position not
// visited, masked probabilities forced to 0, p kept at f32 accuracy for the
// P.V product, and o / max(l, 1e-20), so a fully masked row (t_q > t_k,
// causal) comes out as 0.
//
// 3xTF32: a TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product misses the 1e-4 f32 parity the f32 callers are held to. Each
// operand x is split as x = big + small, big a TF32 value, and a product x.y
// is taken as small.big + big.small + big.big (in that order, f32
// accumulation); only small.small is dropped. The split here truncates: big
// is x with its 13 low mantissa bits cleared (one integer AND), small =
// x - big is exact in f32 (one subtraction), and the tensor cores read
// small's top 19 bits. That keeps about 20 of f32's 24 significant bits
// (the output is within ~1e-5 of the plain version at D=128) for two
// instructions; rounding both parts to nearest costs five on the integer
// pipe, and cvt.rna.tf32.f32 runs on a slower pipe still. Every warp splits
// its own fragments, and on this kernel each extra instruction per split
// showed in its time (PERF.md).
//
// What bounds it on the H100: at the main path's shape (B*H=128, T=1024,
// D=128, causal) the function moves 268 MB (0.0801 ms at 3.35 TB/s) and
// needs 34.4 GFLOP of products, three times over on the TF32 tensor cores:
// 103.2 GFLOP at 495 TFLOP/s is 0.2084 ms (the same work at the 67 TFLOP/s
// f32 rate of the CUDA cores would take 0.5133 ms). So the bound is the
// operations. mma.sync reaches a fraction of that rate on Hopper (wgmma is
// the full-rate path), and what holds this kernel back is the issue and
// latency of the instructions around the products: fragment loads, splits
// and the softmax, in 8 warps a multiprocessor (PERF.md).
//
// Design:
// - mma.sync m16n8k8 TF32. wgmma's TF32 form wants both operands K-major in
//   shared memory, so V would have to be transposed and split there on its
//   way in; mma.sync reads V as it is;
// - one block of 8 warps per 128-query tile of one (batch, head); each warp
//   owns 16 query rows. Q sits in shared memory and each warp reads its A
//   fragments from there, scales them by sm_scale and splits them once per
//   key tile; the S accumulators (16 x 64) and O (16 x D) stay in registers;
// - K and V tiles of 64 keys arrive by cp.async 16-byte copies into a
//   two-stage ring, so tile j+1 loads while tile j is multiplied; rows past
//   Tk are zero-filled (src-size 0) and masked. Rows are padded to D+4 floats:
//   16-byte aligned for cp.async, and the fragment loads of a warp hit 32
//   distinct banks. K and V are split per fragment, in registers, which
//   measured faster than splitting each tile once into shared memory as
//   (big, small) pairs (that doubles the bytes each fragment load moves and
//   halves the key tile that fits);
// - for each fragment the loads and splits of all its B operands come first,
//   then the three passes, each over all accumulators, so no two products in
//   a row share an accumulator;
// - P stays in registers. The S accumulator gives a lane the key columns
//   {2t, 2t+1} of an 8-key step, where the A fragment of P.V wants {t, t+4}.
//   P.V sums over keys, so the contraction order is permuted instead of the
//   data: a lane's A fragment is (p[2t], p[2t+1]) and its B fragment reads
//   V's rows 2t and 2t+1 (b0 <- V[2t], b1 <- V[2t+1]);
// - q, k, v are taken with their own (batch, head, token) strides (unit
//   stride along D, 16-byte aligned), so the heads of a fused qkv projection
//   need no copy;
// - the tiles are ordered on a 1-D grid so that the blocks in flight share
//   heads: groups of heads whose K and V fill at most 16 MB of the 50 MB L2,
//   and within a group the last (under the causal mask the longest) query
//   tile of every head first;
// - masks are applied only on key tiles that cross a warp's diagonal or the
//   key edge; a warp whose rows see none of a key tile skips it (exactly
//   what the plain version's arithmetic gives: p = 0, alpha = 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int WARPS = BQ / 16;   // each warp owns 16 query rows
constexpr int NUM_THREADS = 32 * WARPS;
constexpr int STAGES = 2;        // K/V ring
constexpr float NEG_INF = -1e30f;

// Row stride in floats of a shared-memory tile: D padded by 4.
template <int DP>
__host__ __device__ constexpr int stride() { return DP + 4; }

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)stride<DP>() * (BQ + 2 * STAGES * BK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small: big is x truncated to TF32, small = x - big (exact), read
// by the tensor cores as its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[i] += a.b[i] for the first `n` of N products, in 3xTF32: small.big,
// big.small, big.big. Each pass runs over all of them before the next, so no
// two products in a row share an accumulator and the tensor cores pipeline.
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[N][2],
                                     const uint32_t (&bs)[N][2], int n) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma(c[i], as[0], as[1], as[2], as[3], bb[i][0], bb[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma(c[i], ab[0], ab[1], ab[2], ab[3], bs[i][0], bs[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mma(c[i], ab[0], ab[1], ab[2], ab[3], bb[i][0], bb[i][1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct View {  // a [B, H, T, D] f32 view: base and element strides
  const float* p;
  long long sb, sh, st;
};

// Copies `rows` rows of D floats, from row `r0` of head (bi, hi), into a
// shared tile of stride DP + 4; rows at or past `t` are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const View& x, int bi, int hi, int r0,
                                          int rows, int t, int d) {
  constexpr int CPR = DP / 4;  // 16-byte chunks per padded row
  const float* head = x.p + bi * x.sb + hi * x.sh;
  for (int i = threadIdx.x; i < rows * CPR; i += NUM_THREADS) {
    const int r = i / CPR, c = i % CPR;
    if (4 * c >= d) continue;
    const bool in = r0 + r < t;
    const float* src = in ? head + (long long)(r0 + r) * x.st + 4 * c : head;
    cp_async16(smem_addr(dst + r * stride<DP>() + 4 * c), src, in ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_f32_sm90_kernel(View q, View k, View v, float* __restrict__ o, int bh_total, int h,
                          int heads_per_group, int tq, int tk, int d, float sm_scale,
                          int causal) {
  constexpr int S = stride<DP>();
  constexpr int NDT = DP / 8;  // 8-column steps of D
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][S]
  float* kv = qs + BQ * S;     // STAGES x (K [BK][S], V [BK][S])

  // the tile of this block: heads in groups, the last query tile first
  const int n_qt = (tq - 1) / BQ + 1;
  const int tile = blockIdx.x;
  const int group = tile / (heads_per_group * n_qt);
  const int r = tile - group * heads_per_group * n_qt;
  const int heads = min(heads_per_group, bh_total - group * heads_per_group);
  const int bh = group * heads_per_group + r % heads;
  const int q0 = (n_qt - 1 - r / heads) * BQ;
  const int bi = bh / h, hi = bh - bi * h;
  const int off = tk - tq;  // right-aligned causal offset

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int w0 = q0 + 16 * warp;                 // first query row of this warp
  const int nd = d / 8;
  float* out = o + ((long long)bh * tq) * d;

  int n_kt = (tk - 1) / BK + 1;
  if (causal) {
    const int last_q = off + min(q0 + BQ, tq) - 1;
    n_kt = last_q < 0 ? 0 : min(n_kt, last_q / BK + 1);
  }

  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8

  if (n_kt > 0) load_tile<DP>(qs, q, bi, hi, q0, BQ, tq, d);
  for (int st = 0; st < STAGES && st < n_kt; ++st) {
    load_tile<DP>(kv + st * 2 * BK * S, k, bi, hi, st * BK, BK, tk, d);
    load_tile<DP>(kv + st * 2 * BK * S + BK * S, v, bi, hi, st * BK, BK, tk, d);
    cp_async_commit();
  }
  // the last key position any row of this warp sees
  const int warp_last = off + min(w0 + 15, tq - 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + STAGES - 1 < n_kt) cp_async_wait<STAGES - 1>();
    else cp_async_wait<0>();
    __syncthreads();
    const int k0 = kt * BK;
    const float* ks = kv + (kt % STAGES) * 2 * BK * S;
    const float* vs = ks + BK * S;
    const bool active = w0 < tq && (!causal || k0 <= warp_last);
    if (active) {
      // S = (q * sm_scale) k^T for rows w0 + {g, g+8}, keys k0 + 8n + {2t, 2t+1}
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* qw = qs + (16 * warp + g) * S + t4;
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        if (kk >= nd) break;
        uint32_t ab[4], as[4];
        split(qw[8 * kk] * sm_scale, ab[0], as[0]);
        split(qw[8 * S + 8 * kk] * sm_scale, ab[1], as[1]);
        split(qw[8 * kk + 4] * sm_scale, ab[2], as[2]);
        split(qw[8 * S + 8 * kk + 4] * sm_scale, ab[3], as[3]);
        const float* kr = ks + g * S + 8 * kk + t4;
        uint32_t bb[BK / 8][2], bs[BK / 8][2];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          split(kr[8 * n * S], bb[n][0], bs[n][0]);
          split(kr[8 * n * S + 4], bb[n][1], bs[n][1]);
        }
        mma3<BK / 8>(s, ab, as, bb, bs, BK / 8);
      }

      // masks only where the tile crosses this warp's diagonal or the key edge
      if (k0 + BK > tk || (causal && k0 + BK - 1 > off + w0)) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = w0 + g + 8 * (e >> 1);
            if (key >= tk || (causal && key > row + off)) s[n][e] = NEG_INF;
          }
      }

      // online softmax; a masked score (NEG_INF) gives p = 0
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float p = s[n][e] <= 0.5f * NEG_INF ? 0.f : expf(s[n][e] - m_new);
            s[n][e] = p;
            sum += p;
          }
        const float alpha = expf(m[hr] - m_new);
        l[hr] = l[hr] * alpha + sum;  // this lane's share of the row sum
        m[hr] = m_new;
#pragma unroll
        for (int j = 0; j < NDT; ++j) {
          acc[j][2 * hr] *= alpha;
          acc[j][2 * hr + 1] *= alpha;
        }
      }

      // O += P V over the permuted key order: lane (g, t) holds keys 2t, 2t+1
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t ab[4], as[4];
        split(s[n][0], ab[0], as[0]);  // row g,     key 2t
        split(s[n][2], ab[1], as[1]);  // row g + 8, key 2t
        split(s[n][1], ab[2], as[2]);  // row g,     key 2t + 1
        split(s[n][3], ab[3], as[3]);  // row g + 8, key 2t + 1
        const float* vr = vs + (8 * n + 2 * t4) * S + g;
#pragma unroll
        for (int j0 = 0; j0 < NDT; j0 += 8) {  // 8 column steps of D at a time
          if (j0 >= nd) break;
          uint32_t bb[8][2], bs[8][2];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (j0 + i < nd) {
              split(vr[8 * (j0 + i)], bb[i][0], bs[i][0]);
              split(vr[S + 8 * (j0 + i)], bb[i][1], bs[i][1]);
            }
          }
          mma3<8>(acc + j0, ab, as, bb, bs, nd - j0);
        }
      }
    }
    __syncthreads();  // this stage's K and V are no longer read
    if (kt + STAGES < n_kt) {
      float* dst = kv + (kt % STAGES) * 2 * BK * S;
      load_tile<DP>(dst, k, bi, hi, (kt + STAGES) * BK, BK, tk, d);
      load_tile<DP>(dst + BK * S, v, bi, hi, (kt + STAGES) * BK, BK, tk, d);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = w0 + g + 8 * hr;
    const float den = fmaxf(quad_sum(l[hr]), 1e-20f);
    if (row < tq) {
#pragma unroll
      for (int j = 0; j < NDT; ++j)
        if (j < nd)
          *reinterpret_cast<float2*>(out + (long long)row * d + 8 * j + 2 * t4) =
              make_float2(acc[j][2 * hr] / den, acc[j][2 * hr + 1] / den);
    }
  }
}

template <int DP>
cudaError_t launch(const View& q, const View& k, const View& v, float* o, int b, int h, int tq,
                   int tk, int d, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bh = b * h, n_tiles = bh * ((tq - 1) / BQ + 1);
  // heads whose K and V fill at most 16 MB of the 50 MB L2, so that two
  // groups in flight at a group boundary still fit
  const long long kv_bytes = 2LL * 4 * d * tk;
  const int group = (int)(kv_bytes >= (16LL << 20) ? 1 : ((16LL << 20) / kv_bytes));
  const int heads_per_group = group < bh ? group : bh;
  flash_fwd_f32_sm90_kernel<DP><<<n_tiles, NUM_THREADS, smem, stream>>>(
      q, k, v, o, bh, h, heads_per_group, tq, tk, d, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, tq, D], k/v [B, H, tk, D]: f32 views with element strides
// (batch, head, token) given per operand and unit stride along D; 16-byte
// aligned bases and strides that are multiples of 4 elements. o: a contiguous
// f32 [B, H, tq, D]. D a multiple of 8 up to 128. Launches on `stream` and
// returns 0 or the cudaError_t of the launch.
extern "C" int flash_fwd_f32_sm90(const void* q, const void* k, const void* v, void* o, int b,
                                  int h, int tq, int tk, int d, long long q_sb, long long q_sh,
                                  long long q_st, long long k_sb, long long k_sh,
                                  long long k_st, long long v_sb, long long v_sh,
                                  long long v_st, float sm_scale, int causal, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 ||
      (long long)b * h * ((tq - 1) / BQ + 1) > 0x7fffffffLL || d < 8 || d > 128 || d % 8)
    return (int)cudaErrorInvalidValue;
  const View vq{static_cast<const float*>(q), q_sb, q_sh, q_st};
  const View vk{static_cast<const float*>(k), k_sb, k_sh, k_st};
  const View vv{static_cast<const float*>(v), v_sb, v_sh, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  const cudaError_t err =
      d <= 64 ? launch<64>(vq, vk, vv, out, b, h, tq, tk, d, sm_scale, causal, s)
              : launch<128>(vq, vk, vv, out, b, h, tq, tk, d, sm_scale, causal, s);
  return (int)err;
}
