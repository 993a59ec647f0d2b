// Flash-attention forward for f32 inputs (sm_90a), on the CUDA cores.
//
// Replaces: fedml_tpu/ops/attention.py::_flash_fwd_kernel (lines 59-106), the
// Pallas kernel launched by _flash_fwd (pallas_call at attention.py:124), for
// f32 inputs; bf16 inputs go to the tensor-core kernel in flash_fwd_sm90.cu.
// A TF32 product would not hold the f32 parity (1e-4) the f32 callers need,
// so this kernel keeps full f32 FMAs. The main path (bf16) never launches it.
// Same function: o = softmax(q k^T * sm_scale) v over [BH, T, D] rows, with
// an online softmax (running max m, sum l, accumulator o, all f32), q scaled
// by sm_scale in f32 before the product, the right-aligned causal mask (query
// i sees key j iff j <= i + (t_k - t_q)), key tiles past a query tile's last
// position skipped, masked probabilities forced to 0, p kept in f32 for the
// P.V product, and o / max(l, 1e-20). A fully masked row (t_q > t_k,
// causal) therefore comes out as 0.
//
// What bounds it on the H100: at B*H=128, T=1024, D=128, causal, f32, the
// function moves 268 MB (~80 us at 3.35 TB/s) and needs 34 GFLOP of products
// (~513 us at the 67 TFLOP/s f32 peak of the CUDA cores), so the bound is the
// operations. The kernel reads its operands from shared memory one column at
// a time, so it is bound by shared-memory loads and FMA issue.
//
// Design, simple first:
// - grid (B*H, ceil(Tq/BQ)); one block of 16x16 threads owns BQ=64 query
//   rows of one (batch, head) and walks the key tiles of BK=64 keys in order
//   (the loop that takes the place of the TPU's sequential key-block loop);
// - the Q tile (pre-scaled), one K tile, one V tile and the P tile live in
//   dynamic shared memory, rows of Q and K padded to D+1 floats so
//   the threads of a half-warp read distinct banks;
// - each thread holds a 4x4 block of S and a 4x8 block of O in registers,
//   and the row max and row sum of S reduce over the 16 threads of a row
//   with xor shuffles, which leave the same value in every lane, so the
//   per-row m and l stay identical across those threads;
// - rows and keys past Tq / Tk (the ragged edge) are masked, so any Tq, Tk
//   works; D is any multiple of 8 up to 128.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;          // threads along keys (S) and head dim (O)
constexpr int TY = 16;          // threads along query rows
constexpr int RQ = BQ / TY;     // query rows per thread
constexpr int RK = BK / TX;     // keys per thread
constexpr int DMAX = 128;
constexpr int RD = DMAX / TX;   // head-dim columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1));
}

__global__ void __launch_bounds__(TX * TY)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int tq, int tk, int d,
                 float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;              // [BQ][d+1], q * sm_scale
  float* ks = qs + BQ * dp;      // [BK][d+1]
  float* vs = ks + BK * dp;      // [BK][d]
  float* ps = vs + BK * d;       // [BQ][BK+1]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int q0 = blockIdx.y * BQ;
  const size_t bh = blockIdx.x;
  const float* qb = q + bh * (size_t)tq * d;
  const float* kb = k + bh * (size_t)tk * d;
  const float* vb = v + bh * (size_t)tk * d;
  float* ob = o + bh * (size_t)tq * d;
  const int off = tk - tq;  // right-aligned causal offset

  for (int i = tid; i < BQ * d; i += TX * TY) {
    const int r = i / d, c = i - r * d;
    const float x = (q0 + r < tq) ? qb[(size_t)(q0 + r) * d + c] : 0.f;
    qs[r * dp + c] = x * sm_scale;
  }

  int n_kt = (tk + BK - 1) / BK;
  if (causal) {
    // only key tiles at or before this query tile's last position
    const int last_q = off + min(q0 + BQ, tq) - 1;
    n_kt = last_q < 0 ? 0 : min(n_kt, last_q / BK + 1);
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * d; i += TX * TY) {
      const int r = i / d, c = i - r * d;
      const bool in = k0 + r < tk;
      const size_t g = (size_t)(k0 + r) * d + c;
      ks[r * dp + c] = in ? kb[g] : 0.f;
      vs[r * d + c] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    // S = (q * sm_scale) k^T for this thread's rows ty*RQ+i and keys tx+j*TX
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty * RQ + i) * dp + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ks[(tx + j * TX) * dp + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = off + q0 + ty * RQ + i;
      bool ok[RK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + j * TX;
        ok[j] = kpos < tk && (!causal || kpos <= qpos);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty * RQ + i) * (BK + 1) + tx + j * TX] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V, P in f32
    const int kn = min(BK, tk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty * RQ + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int col = tx + j * TX;
        const float vv = col < d ? vs[c * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= tq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int col = tx + j * TX;
      if (col < d) ob[(size_t)row * d + col] = acc[i][j] / den;
    }
  }
}

}  // namespace

// q [bh, tq, d], k/v [bh, tk, d], o [bh, tq, d], contiguous float. Launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                         int tq, int tk, int d, float sm_scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (tq - 1) / BQ + 1 > 65535 || d < 8 || d > DMAX || d % 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq - 1) / BQ + 1);
  const dim3 block(TX, TY);
  flash_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), tq, tk, d, sm_scale, causal);
  return (int)cudaGetLastError();
}
