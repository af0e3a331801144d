// Hand-written Hopper (sm_90a) causal flash attention of the LM prefill.
//
// flash_attention — replaces src/repro/kernels/flash_attention.py:65
//   (flash_attention_pallas, body _flash_kernel).  For every (batch * head)
//   slice and query row i it computes
//     o[i] = sum_{j <= i} softmax_j((q[i] . k[j]) * scale) v[j]
//   with scale = hd^-0.5, an fp32 online softmax (running max m and running
//   sum l, masked scores NEG_INF = -1e30 so the exponents stay finite),
//   fp32 accumulation, and the output acc / max(l, 1e-30) rounded once to
//   the input type (bf16 or fp32).  q is (BH, S, hd); k and v are
//   (BH / groups, S, hd), and q head bh reads KV head bh / groups
//   ((bh / H) * KV + (bh % H) / G for BH = B * H, H = KV * G), so GQA and
//   MQA need no expanded copy of K and V.  S is any length: keys at or past
//   S are masked, queries past S are not stored.  hd is 32, 64, 128 or 256
//   (every head dim of the repo's configs).
//
//   Bound on the H100: operations.  Causal attention does 4 * hd flops per
//   (query, key <= query) pair, 2 * hd * S * (S + 1) a head, against
//   (2 * BH + 2 * BKV) * S * hd * 2 bytes of q, k, v and o in bf16: (S + 1)
//   / 4 flops per byte for MHA whatever hd is, more for GQA and MQA.  The
//   card's bf16 tensor cores do 989 TFLOP/s against 3.35 TB/s (295 flops a
//   byte), so from S ~ 1,200 (MHA; ~660 for paligemma's MQA) the
//   operations set the bound at every hd: at S = 1966, (16, S, 128) MHA,
//   0.0163 ms; at paligemma's S = 2047, (8, S, 256) over one KV head,
//   0.0170 ms.
//
//   bf16 (the served type): flash_fwd_mma, the FlashAttention-2 shape on
//   mma.sync.aligned.m16n8k16 bf16 -> fp32.  One block of 4 warps per
//   (bh, 64-query tile); each warp owns 16 query rows and every output row
//   is written by exactly one warp, with no atomics and a fixed summation
//   order, so two runs give identical bits.  Tiles launch longest first
//   (all heads' last query tiles, then the ones before), consecutive blocks
//   sharing a KV head under GQA.  The block walks its BK-key K/V tiles up
//   to the causal limit (the TPU kernel's fori_loop over KV blocks):
//   - Q, K and V tiles arrive in shared memory by cp.async, zero-filled
//     past S (src-size 0), K/V double-buffered so tile t + 1 loads while
//     tile t computes.  Rows are padded by 16 bytes (an odd number of
//     16-byte chunks a row), so the eight row addresses of an ldmatrix
//     phase fall in eight distinct bank groups: conflict-free without a
//     swizzle.
//   - S = Q K^T: Q fragments (ldmatrix; held in registers at hd <= 128,
//     reloaded from shared memory per k-step at hd 256) against K
//     fragments (ldmatrix), fp32 accumulators in registers.  The fp32
//     scores are then multiplied by scale * log2(e) (never q rounded to
//     bf16 after scaling: hd^-0.5 is not a power of two at hd 32 or 128),
//     masked, and exponentiated with exp2f.
//   - O += P V: the score accumulators, packed to bf16 pairs, are the A
//     operand directly (P never goes to shared memory); V fragments come
//     by ldmatrix.trans.  P is split into a bf16 high half and a bf16 low
//     half (p - hi, rounded), and both go through the tensor cores, so P
//     is carried to about 2^-16 relative, as the Pallas kernel and the
//     plain version keep P in fp32; P rounded to bf16 alone would carry an
//     error of 2^-9 on every p.  The split doubles the P V MMAs: half
//     again as many MMAs in all (192 against 128 a warp and tile at hd
//     128).
//   Tiles: BK = 64 keys at hd <= 128, 32 at hd 256 (its O accumulator is
//   hd / 2 = 128 fp32 registers a thread).  Shared memory (Q + two K/V
//   stages, padded): 25,600 / 46,080 / 87,040 / 101,376 B at hd 32 / 64 /
//   128 / 256, so two blocks (8 warps) an SM at hd 128 and 256.  Registers
//   and spills: `-Xptxas -v` in the build log (chip_smoke.py prints them
//   and fails on a spill; PERF.md records them).  Neither 32-key tiles, nor
//   Q reloaded from shared memory at hd 128, nor three or four blocks an
//   SM (forced by register caps) made it faster.
//   Left for a later pass: wgmma fed by TMA (the only path to the full
//   tensor-core rate), and MQA/GQA blocks that share one K/V tile among
//   the q heads of a KV head.
//
//   fp32 (a parity type, not a served one): flash_fwd_f32, the CUDA-core
//   body — one block of 8 warps per (bh, 64-query tile), fp32 Q/K/V/P
//   tiles in shared memory, a lane scoring keys lane and lane + 32 and
//   accumulating hd / 32 output columns — exact to fp32 rounding (TF32
//   would keep three digits against a 1e-4 tolerance).  q * scale is taken
//   in fp32 before the product.  At hd 256 its tiles take 213,248 B of
//   dynamic shared memory (one block an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async, ldmatrix.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;  // 16 query rows a warp

template <int HD>
struct MmaTile {
  static constexpr int BK = HD <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int LD = HD + 8;  // padded row, in bf16 elements
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 2;  // Q, 2 x (K, V)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes 16 zero bytes, reads none.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The pair (x0, x1) (x0 in the low half, the lower column) as a bf16 high
// part and the bf16 rounding of what it leaves: x = hi + lo to ~2^-16.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// The explicit minimum of one block an SM lets ptxas spend up to 255
// registers (226 at hd 128 against 178 without it), which it uses to keep
// more fragments in flight; shared memory caps the blocks an SM at two
// either way.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, long long n_bh, int S,
              int groups, float scale_log2) {
  using Tile = MmaTile<HD>;
  constexpr int BK = Tile::BK, LD = Tile::LD;
  constexpr int CH = HD / 8;         // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;    // k-steps of S = Q K^T
  constexpr int NT = BK / 8;         // 8-key score tiles a warp
  constexpr int OT = HD / 8;         // 8-column output tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;          // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;      // [2][BK][LD]

  const int n_qt = (S + BQ - 1) / BQ;
  const long long bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - (int)(blockIdx.x / n_bh);  // longest first
  const int q0 = qt * BQ;
  const long long kvh = bh / groups;
  const __nv_bfloat16* qb = q + bh * (long long)S * HD;
  const __nv_bfloat16* kb = k + kvh * (long long)S * HD;
  const __nv_bfloat16* vb = v + kvh * (long long)S * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int wq = q0 + warp * 16;            // this warp's first query row
  const int kv_end = min(q0 + BQ, S);       // keys [0, kv_end) are read
  const int n_kt = (kv_end + BK - 1) / BK;

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, ch = c % CH, s = q0 + r;
    cp_async16(smem_addr(Qs + r * LD + ch * 8),
               qb + (long long)min(s, S - 1) * HD + ch * 8, s < S);
  }
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    __nv_bfloat16* kd = Ks + st * BK * LD;
    __nv_bfloat16* vd = Vs + st * BK * LD;
    for (int c = tid; c < BK * CH; c += MMA_THREADS) {
      const int r = c / CH, ch = c % CH, s = k0 + r;
      const long long off = (long long)min(s, S - 1) * HD + ch * 8;
      cp_async16(smem_addr(kd + r * LD + ch * 8), kb + off, s < S);
      cp_async16(smem_addr(vd + r * LD + ch * 8), vb + off, s < S);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  // Q as A (16 x 16): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15).
  const uint32_t q_frag =
      smem_addr(Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                (lane >> 4) * 8);
  // K as B for two 8-key tiles: (keys 0-7, d 0-7 | d 8-15), (keys 8-15, ..).
  const int k_frag =
      ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  // V as B (transposed) for two 8-column tiles: (keys 0-7 | 8-15) x cols.
  const int v_frag =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  uint32_t qf[Tile::Q_IN_REGS ? KSTEPS : 1][4];
  float oacc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
    oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Tile::Q_IN_REGS) {
      if (kt == 0) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldmatrix_x4(qf[ks], q_frag + ks * 32);
      }
    }
    const int k0 = kt * BK;
    // A warp whose rows all precede the tile (hd 256's last tile) skips it.
    if (k0 <= wq + 15) {
      const uint32_t kst = smem_addr(Ks + st * BK * LD + k_frag);
      const uint32_t vst = smem_addr(Vs + st * BK * LD + v_frag);
      float sacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[4];
        if constexpr (Tile::Q_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
        } else {
          ldmatrix_x4(a, q_frag + ks * 32);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kst + (j * 8 * LD + ks * 16) * 2);
          mma_bf16(sacc[j], a, b[0], b[1]);
          mma_bf16(sacc[j + 1], a, b[2], b[3]);
        }
      }

      // Scores: scale (with log2 e) in fp32, mask, online softmax.  Entry
      // e of tile j is row g + 8 * (e / 2), key k0 + 8 j + 2 t4 + e % 2.
      const bool edge = k0 + BK - 1 > wq || k0 + BK > S;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sacc[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + 2 * t4 + (e & 1);
            const int row = wq + g + (e >> 1) * 8;
            if (key > row || key >= S) s = NEG_INF;
          }
          sacc[j][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sacc[j][e] - m[e >> 1]);
          sacc[j][e] = p;
          rs[e >> 1] += p;
        }
      }
      // l is this thread's share of its rows' sums (its columns); the
      // four threads of a row are added once, at the end.
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        oacc[t][0] *= corr[0];
        oacc[t][1] *= corr[0];
        oacc[t][2] *= corr[1];
        oacc[t][3] *= corr[1];
      }

      // O += P V, P as the A operand straight from the score registers.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int t = 0; t < OT; t += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vst + (kk * 16 * LD + t * 8) * 2);
          mma_bf16(oacc[t], ph, b[0], b[1]);
          mma_bf16(oacc[t + 1], ph, b[2], b[3]);
          mma_bf16(oacc[t], pl, b[0], b[1]);
          mma_bf16(oacc[t + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is reloaded next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + (bh * S + row) * HD + 2 * t4;
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          oacc[t][2 * r] / den, oacc[t][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(out + t * 8) = pair;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, fp32 tiles in shared memory.
// ---------------------------------------------------------------------------

constexpr int BK32 = 64;                // keys per K/V tile
constexpr int F32_WARPS = 8;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int ROWS = BQ / F32_WARPS;    // query rows per warp

template <int HD>
constexpr int f32_smem_floats() {
  // Qs [BQ][HD], Ks [BK32][HD + 1] (odd stride: a lane per key row, no bank
  // conflicts), Vs [BK32][HD], Ps [F32_WARPS][ROWS][BK32].
  return BQ * HD + BK32 * (HD + 1) + BK32 * HD + F32_WARPS * ROWS * BK32;
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int groups, float scale) {
  constexpr int DPL = HD / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK32 * (HD + 1);
  float* Ps = Vs + BK32 * HD;

  const int n_qt = (S + BQ - 1) / BQ;
  const long long bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // longest first
  const int q0 = qt * BQ;
  const long long kvh = bh / groups;
  const float* qb = q + bh * (long long)S * HD;
  const float* kb = k + kvh * (long long)S * HD;
  const float* vb = v + kvh * (long long)S * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * ROWS;
  float* Pw = Ps + warp * ROWS * BK32;

  for (int e = tid; e < BQ * HD; e += F32_THREADS) {
    const int r = e / HD, c = e % HD, s = q0 + r;
    Qs[e] = s < S ? __fmul_rn(qb[(long long)s * HD + c], scale) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  // BQ == BK32: query tile qt meets key tiles 0..qt; keys >= S are masked.
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();  // Qs written; the previous tile's readers are done
    for (int e = tid; e < BK32 * HD; e += F32_THREADS) {
      const int r = e / HD, c = e % HD, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = kb[(long long)s * HD + c];
        vx = vb[(long long)s * HD + c];
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
      Pw[i * BK32 + lane] = pa;
      Pw[i * BK32 + lane + 32] = pb;
    }
    __syncwarp();
    for (int j = 0; j < BK32; ++j) {
      float vj[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) vj[t] = Vs[j * HD + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Pw[i * BK32 + j];
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
    float* out = o + (bh * S + qp) * HD;
#pragma unroll
    for (int t = 0; t < DPL; ++t) out[lane + 32 * t] = acc[i][t] / den;
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long bh, int S, int groups, float scale,
                cudaStream_t stream) {
  constexpr int bytes = MmaTile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = bh * ((S + BQ - 1) / BQ);
  flash_fwd_mma<HD><<<(unsigned)n_blocks, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      bh, S, groups, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               long long bh, int S, int groups, float scale,
               cudaStream_t stream) {
  constexpr int bytes = f32_smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = bh * ((S + BQ - 1) / BQ);
  flash_fwd_f32<HD><<<(unsigned)n_blocks, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, groups, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           long long bh, int S, int groups, int is_bf16, float scale,
           cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, o, bh, S, groups, scale, stream)
                 : launch_f32<HD>(q, k, v, o, bh, S, groups, scale, stream);
}

}  // namespace

extern "C" {

// q, o: (bh, s, hd); k, v: (bh / groups, s, hd); all contiguous, 16-byte
// aligned, of one type (bf16 when is_bf16, else fp32).  hd in {32, 64,
// 128, 256}.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long bh, int s, int hd, int groups, int is_bf16,
                    float scale, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (bh * ((s + BQ - 1) / BQ) >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b16 = is_bf16;
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 64: return launch<64>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 128: return launch<128>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 256: return launch<256>(q, k, v, o, bh, s, groups, b16, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
