// Hand-written Hopper (sm_90a) causal flash attention of the LM prefill.
//
// flash_attention — replaces src/repro/kernels/flash_attention.py:65
//   (flash_attention_pallas, body _flash_kernel).  For every (batch * head)
//   slice and query row i it computes
//     o[i] = sum_{j <= i} softmax_j((q[i] * scale) . k[j]) v[j]
//   with scale = hd^-0.5 applied to q in fp32, an fp32 online softmax
//   (running max m and running sum l, masked scores NEG_INF = -1e30 so the
//   exponents stay finite), fp32 accumulation, and the output
//   acc / max(l, 1e-30) rounded to the input type (fp32 or bf16).
//   q is (BH, S, hd); k and v are (BH / groups, S, hd), and q head bh reads
//   KV head bh / groups ((bh / H) * KV + (bh % H) / G for BH = B * H,
//   H = KV * G), so GQA needs no expanded copy of K and V.  S is any length:
//   keys at or past S are masked, queries past S are not stored.
//
//   Bound on the H100: operations.  Causal attention does 4 * hd flops per
//   (query, key <= query) pair, which at hd = 128 is ~37 flops per byte of
//   q, k, v and o moved; the card's bf16 tensor cores (989 TFLOP/s) make
//   that the larger of the two bounds at prefill lengths.  This first
//   design runs both products on the CUDA cores in fp32 (67 TFLOP/s peak,
//   and shared-memory bound below that), so it sits far off the bound;
//   mma.sync / wgmma tiles fed by TMA are the later redesign.
//
//   Design: one block of 8 warps per (bh, 64-query tile); the tiles are
//   launched longest first (the last query tile reads the most keys).  The
//   block keeps its scaled queries in shared memory and loops over 64-key
//   K/V tiles up to the causal limit (this loop replaces the TPU kernel's
//   fori_loop over KV blocks), staging each tile in shared memory as fp32.
//   Each warp owns 8 query rows: a lane scores keys lane and lane + 32,
//   the row max and sum are warp shuffles, the probabilities go through a
//   warp-private shared tile, and a lane accumulates hd / 32 output
//   columns of each row.  Every output row is written by exactly one
//   block, with no atomics and a fixed summation order, so two runs give
//   identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per K/V tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;        // query rows per warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr int smem_floats() {
  // Qs [BQ][HD], Ks [BK][HD + 1] (odd stride: a lane per key row, no bank
  // conflicts), Vs [BK][HD], Ps [WARPS][ROWS][BK].
  return BQ * HD + BK * (HD + 1) + BK * HD + WARPS * ROWS * BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int groups,
          float scale) {
  constexpr int DPL = HD / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;

  const int n_qt = (S + BQ - 1) / BQ;
  const long long bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // longest first
  const int q0 = qt * BQ;
  const long long kvh = bh / groups;
  const T* qb = q + bh * (long long)S * HD;
  const T* kb = k + kvh * (long long)S * HD;
  const T* vb = v + kvh * (long long)S * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * ROWS;
  float* Pw = Ps + warp * ROWS * BK;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD, s = q0 + r;
    Qs[e] = s < S ? __fmul_rn(to_f32(qb[(long long)s * HD + c]), scale)
                  : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  // BQ == BK: query tile qt meets key tiles 0..qt; keys >= S are masked.
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Qs written; the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f32(kb[(long long)s * HD + c]);
        vx = to_f32(vb[(long long)s * HD + c]);
      }
      Ks[r * (HD + 1) + c] = kx;
      Vs[r * HD + c] = vx;
    }
    __syncthreads();

    float s0[ROWS], s1[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s0[i] = s1[i] = 0.f;
    const float* ka = Ks + lane * (HD + 1);
    const float* kb2 = Ks + (lane + 32) * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float a = ka[d], b = kb2[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = Qs[(r0 + i) * HD + d];
        s0[i] = fmaf(qv, a, s0[i]);
        s1[i] = fmaf(qv, b, s1[i]);
      }
    }

    const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + r0 + i;
      const float a = (ja <= qp && ja < S) ? s0[i] : NEG_INF;
      const float b = (jb <= qp && jb < S) ? s1[i] : NEG_INF;
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[i][t] *= corr;
      Pw[i * BK + lane] = pa;
      Pw[i * BK + lane + 32] = pb;
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
      float vj[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) vj[t] = Vs[j * HD + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Pw[i * BK + j];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[i][t] = fmaf(p, vj[t], acc[i][t]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + (bh * S + qp) * HD;
#pragma unroll
    for (int t = 0; t < DPL; ++t) store(out + lane + 32 * t, acc[i][t] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           long long n_blocks, int S, int groups, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd<T, HD><<<(unsigned)n_blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, groups, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             long long n_blocks, int S, int hd, int groups, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, n_blocks, S, groups, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, n_blocks, S, groups, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, n_blocks, S, groups, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (bh, s, hd); k, v: (bh / groups, s, hd); all contiguous, of one
// type (bf16 when is_bf16, else fp32).  hd in {32, 64, 128}.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long bh, int s, int hd, int groups, int is_bf16,
                    float scale, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  const long long n_blocks = bh * ((s + BQ - 1) / BQ);
  if (n_blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, n_blocks, s, hd, groups,
                                   scale, st);
  return dispatch<float>(q, k, v, o, n_blocks, s, hd, groups, scale, st);
}

}  // extern "C"
